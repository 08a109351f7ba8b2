#!/usr/bin/env python
"""Do loop closures actually pay on DRIFTING data?  (round 4)

On the clean simulator bench, closures nudge ATE slightly WORSE (the
scan-to-scan loop edges are noisier than near-perfect sim odometry —
PERF.md graph section); this measures the regime closures exist for:
an adversarial revisit log (180-degree FoV, 20% dropout, slips, systematic
odometry drift — io/datasets.simulate_adversarial_log) over the turning
rect_revisit trajectory, replayed three ways:

  odometry   integrate the drifting odometry only
  hector     HectorSLAM + production guards, odometry-delta prior
  graph      + keyframes, loop closures, pose-graph optimization

Usage: python scripts/bench_graph_adversarial.py [--platform cpu]
"""
import argparse
import dataclasses
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", choices=["cpu", "gpu"], default="gpu")
    ap.add_argument("--loops", type=int, default=2)
    args = ap.parse_args()
    if args.platform == "cpu":
        os.environ.setdefault("XLA_FLAGS",
                              "--xla_force_host_platform_device_count=8")
    from slamnet_tpu.runtime import select_platform, setup_compile_cache
    select_platform(args.platform)
    setup_compile_cache()
    import jax
    import numpy as np
    import jax.numpy as jnp

    from slamnet_tpu.core import HectorConfig, PoseGraphConfig
    from slamnet_tpu.core.scan import Scan
    from slamnet_tpu.graph import frontend
    from slamnet_tpu.io import datasets
    from slamnet_tpu.models import graph_slam, hector
    from slamnet_tpu.sim.trajectory import rect_revisit_trajectory

    drive = rect_revisit_trajectory(num_loops=args.loops)
    log = datasets.simulate_adversarial_log(n_scans=drive.shape[0],
                                            trajectory=drive, seed=13)
    T, N = log.ranges.shape
    pts_all = datasets.log_points(log)
    odo = log.odometry
    truth = log.truth

    hcfg = dataclasses.replace(
        HectorConfig(), num_levels=3, estimate_iterations=(7, 4, 4),
        map_resolution=0.1, xy_step_clamp_px=10.0, max_match_jump=1.0,
        gn_damping=0.1, matcher_mode="onehot_bf16")
    gcfg = PoseGraphConfig()
    mcfg = frontend.ScanMatchConfig(matcher_mode="onehot_bf16",
                                    dense_fill=True)

    def ate(track):
        pe = np.linalg.norm(np.asarray(track)[:, :2] - truth[:, :2], axis=1)
        return float(np.sqrt((pe ** 2).mean())), float(pe.max())

    def run(with_graph):
        if with_graph:
            st = graph_slam.init(hcfg, gcfg, odo[0], N)
            step = jax.jit(lambda st, p, v, f: graph_slam.update(
                st, Scan(p, v, jnp.zeros(3, jnp.float32)), hcfg, gcfg,
                mcfg=mcfg, map_without_matching=f))
        else:
            st = hector.init(hcfg, odo[0])
            step = jax.jit(lambda st, p, v, h, f: hector.update(
                st, Scan(p, v, jnp.zeros(3, jnp.float32)), h, hcfg,
                map_without_matching=f))
        prev = odo[0]
        track = []
        for t in range(T):
            d = odo[t] - prev
            d[2] = math.remainder(float(d[2]), 2.0 * math.pi)
            prev = odo[t]
            p = jnp.asarray(pts_all[t])
            v = jnp.asarray(log.valid[t])
            if with_graph:
                h = st.hector._replace(match_pose=jnp.asarray(
                    np.asarray(st.hector.match_pose) + d, jnp.float32))
                st = st._replace(hector=h)
                st, _ = step(st, p, v, jnp.asarray(t < 10))
                if t < 10:
                    st = st._replace(hector=st.hector._replace(
                        match_pose=jnp.asarray(odo[t], jnp.float32)))
                track.append(np.asarray(st.hector.match_pose))
            else:
                hint = np.asarray(st.match_pose) + d
                st, _ = step(st, p, v, jnp.asarray(hint, jnp.float32),
                             jnp.asarray(t < 10))
                if t < 10:
                    st = st._replace(
                        match_pose=jnp.asarray(odo[t], jnp.float32))
                track.append(np.asarray(st.match_pose))
        extra = ""
        if with_graph:
            extra = (f"  keyframes={int(st.graph.num_nodes)}"
                     f" loops={int(st.loop_count)}")
        return ate(track), extra

    oe = np.linalg.norm(odo[:, :2] - truth[:, :2], axis=1)
    print(f"{T} scans x {N} beams (adversarial revisit, "
          f"{1 - log.valid.mean():.0%} dropout)")
    print(f"odometry-only: rms {np.sqrt((oe ** 2).mean()):.4f} "
          f"max {oe.max():.4f}")
    (r, m), _ = run(False)
    print(f"hector+guards: rms {r:.4f} max {m:.4f}")
    (r, m), extra = run(True)
    print(f"graph-slam   : rms {r:.4f} max {m:.4f}{extra}")


if __name__ == "__main__":
    main()
