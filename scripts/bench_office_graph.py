#!/usr/bin/env python
"""The world where loop closure pays (VERDICT r04 item 3).

sim/field.office_field: four ~18 m rooms, 3 m doorways, ~36 m across — while
the benchmark Hector map covers 20 m (map_size=200 @ 0.1 m/px).  A two-lap
room tour with drifting wheel odometry (io/datasets.drifting_odometry) and a
10 m-range lidar therefore OUTRUNS the map for ~3/4 of each lap:

  * scan-to-map tracking — which in a persistent global map acts as implicit
    loop closure and measured net-neutral on every in-map bench
    (PERF.md) — has nothing to match against in rooms B/C/D, so the
    track rides the drifting odometry prior (bounded by the
    min_match_in_map_frac guard at the map boundary);
  * the pose graph stores keyframe SCANS, so its loop-closure path
    (scan-to-scan local grids, frontend.match_scans) works anywhere; on each
    revisit the accepted closures snap the live pose AND the optimizer
    redistributes the accumulated error over the tour's keyframes.

Four tracks are reported: integrated odometry, hector-only (same guards),
graph-SLAM online (causal), and the graph's OPTIMIZED keyframe trajectory —
the standard offline SLAM ATE.  Done-criterion: optimized keyframe ATE beats
the hector-only keyframe ATE by >= 2x (tests/test_office_loop.py asserts it
on a shortened tour).

Usage: python scripts/bench_office_graph.py [--platform cpu] [--loops 2]
"""
import argparse
import dataclasses
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", choices=["cpu", "gpu"], default="gpu")
    ap.add_argument("--loops", type=int, default=2)
    ap.add_argument("--step", type=float, default=0.25)
    ap.add_argument("--max-range", type=float, default=10.0)
    args = ap.parse_args()
    from slamnet_tpu.runtime import select_platform, setup_compile_cache
    select_platform(args.platform)
    setup_compile_cache()
    import jax
    import numpy as np
    import jax.numpy as jnp

    from slamnet_tpu.core import HectorConfig, PoseGraphConfig
    from slamnet_tpu.core.scan import Scan
    from slamnet_tpu.graph import frontend
    from slamnet_tpu.io.datasets import drifting_odometry
    from slamnet_tpu.models import graph_slam, hector
    from slamnet_tpu.sim import lidar
    from slamnet_tpu.sim.field import office_field
    from slamnet_tpu.sim.trajectory import office_tour_trajectory

    boot = 10
    fld = office_field()
    drive = office_tour_trajectory(num_loops=args.loops, step=args.step)
    traj = np.concatenate([np.tile(drive[0], (boot, 1)), drive]).astype(
        np.float64)
    T = traj.shape[0]
    n_beams = 400
    angles = jnp.asarray(lidar.revolution_angles(n_beams))

    @jax.jit
    def genlog(poses, key):
        keys = jax.random.split(key, poses.shape[0])

        def one(p, k):
            return lidar.scan_revolution(fld, p, angles, args.max_range,
                                         0.02, k, range_error_std=0.03)
        return jax.vmap(one)(poses, keys)

    radii, valids = genlog(jnp.asarray(traj, jnp.float32),
                           jax.random.PRNGKey(3))
    odo = drifting_odometry(traj, scale_bias=1.02, heading_bias=0.0002,
                            step_noise=0.003, heading_noise=0.001, seed=7)
    deltas = np.zeros_like(odo)
    deltas[1:] = odo[1:] - odo[:-1]
    for t in range(1, T):
        deltas[t, 2] = math.remainder(float(deltas[t, 2]), 2.0 * math.pi)

    # the 20 m map + production guards; BOTH tracks use the same config
    hcfg = dataclasses.replace(
        HectorConfig(), num_levels=3, map_size=200,
        estimate_iterations=(7, 4, 4), xy_step_clamp_px=10.0,
        max_match_jump=1.0, gn_damping=0.1, min_match_in_map_frac=0.7)
    gcfg = dataclasses.replace(PoseGraphConfig(), keyframe_dist=1.0,
                               loop_closure_radius=4.0)
    mcfg = frontend.ScanMatchConfig(matcher_mode="onehot_bf16",
                                    dense_fill=True)

    force = jnp.arange(T) < boot
    deltas_d = jnp.asarray(deltas, jnp.float32)
    odo_d = jnp.asarray(odo, jnp.float32)

    def pe_of(track):
        return np.linalg.norm(np.asarray(track)[:, :2] - traj[:, :2], axis=1)

    def ate(pe):
        return float(np.sqrt((pe ** 2).mean())), float(pe.max())

    # ---- hector-only ------------------------------------------------------
    @jax.jit
    def replay_hector(state, radii, valids, force, deltas, odo_t):
        def body(st, inp):
            r, v, f, d, o = inp
            pts = jnp.stack([r * jnp.cos(angles), r * jnp.sin(angles)], -1)
            st, _ = hector.update(st, Scan(pts, v, jnp.zeros(3, jnp.float32)),
                                  st.match_pose + d, hcfg, f)
            st = st._replace(match_pose=jnp.where(f, o, st.match_pose))
            return st, st.match_pose
        return jax.lax.scan(body, state, (radii, valids, force, deltas,
                                          odo_t))

    def run_hector():
        st = hector.init(hcfg, traj[0])
        stf, track = replay_hector(st, radii, valids, force, deltas_d, odo_d)
        jax.block_until_ready(stf)
        best = float("inf")
        for _ in range(2):
            t0 = time.time()
            stf, track = replay_hector(st, radii, valids, force, deltas_d,
                                       odo_d)
            jax.block_until_ready(stf)
            best = min(best, time.time() - t0)
        return np.asarray(track), T / best

    # ---- graph-SLAM -------------------------------------------------------
    @jax.jit
    def replay_graph(state, radii, valids, force, deltas, odo_t):
        def body(st, inp):
            r, v, f, d, o = inp
            pts = jnp.stack([r * jnp.cos(angles), r * jnp.sin(angles)], -1)
            st = st._replace(hector=st.hector._replace(
                match_pose=st.hector.match_pose + d))
            st, info = graph_slam.update(
                st, Scan(pts, v, jnp.zeros(3, jnp.float32)), hcfg, gcfg,
                mcfg=mcfg, map_without_matching=f)
            st = st._replace(hector=st.hector._replace(
                match_pose=jnp.where(f, o, st.hector.match_pose)))
            return st, (st.hector.match_pose, info.keyframe_added)
        return jax.lax.scan(body, state, (radii, valids, force, deltas,
                                          odo_t))

    def run_graph():
        st = graph_slam.init(hcfg, gcfg, traj[0], n_beams)
        stf, (track, kf_flags) = replay_graph(st, radii, valids, force,
                                              deltas_d, odo_d)
        jax.block_until_ready(stf)
        best = float("inf")
        for _ in range(2):
            t0 = time.time()
            stf, (track, kf_flags) = replay_graph(st, radii, valids, force,
                                                  deltas_d, odo_d)
            jax.block_until_ready(stf)
            best = min(best, time.time() - t0)
        return stf, np.asarray(track), np.asarray(kf_flags), T / best

    oe = pe_of(odo)
    h_track, h_rate = run_hector()
    he = pe_of(h_track)
    stf, g_track, kf_flags, g_rate = run_graph()
    ge = pe_of(g_track)

    n_nodes = int(stf.graph.num_nodes)
    kf_scans = np.concatenate([[0], np.where(kf_flags)[0]])[:n_nodes]
    opt = np.asarray(stf.graph.poses)[:n_nodes]
    tk = traj[kf_scans]
    ke_opt = np.linalg.norm(opt[:, :2] - tk[:, :2], axis=1)
    ke_hec = he[kf_scans]
    ke_onl = ge[kf_scans]

    r, m = ate(oe)
    print(f"{T} scans, {n_nodes} keyframes, "
          f"{int(stf.loop_count)} loop closures accepted")
    print(f"odometry only  : ATE {r:.3f}  max {m:.3f}")
    r, m = ate(he)
    print(f"hector-only    : ATE {r:.3f}  max {m:.3f}  final {he[-1]:.3f}  "
          f"({h_rate:.0f} scans/s)")
    r, m = ate(ge)
    print(f"graph online   : ATE {r:.3f}  max {m:.3f}  final {ge[-1]:.3f}  "
          f"({g_rate:.0f} scans/s)")
    print("KEYFRAME trajectory (the offline SLAM metric):")
    print(f"  hector-only      ATE {math.sqrt((ke_hec ** 2).mean()):.3f}  "
          f"max {ke_hec.max():.3f}")
    print(f"  graph online     ATE {math.sqrt((ke_onl ** 2).mean()):.3f}  "
          f"max {ke_onl.max():.3f}")
    print(f"  graph OPTIMIZED  ATE {math.sqrt((ke_opt ** 2).mean()):.3f}  "
          f"max {ke_opt.max():.3f}")
    ratio = math.sqrt((ke_hec ** 2).mean()) / max(
        math.sqrt((ke_opt ** 2).mean()), 1e-9)
    print(f"  margin: optimized beats hector-only {ratio:.2f}x")


if __name__ == "__main__":
    main()
