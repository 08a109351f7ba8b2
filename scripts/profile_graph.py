#!/usr/bin/env python
"""Graph-SLAM keyframe-event cost attribution (round 4).

Replays the bench's turning revisit trajectory (512 scans, ~63 keyframes,
~30 closures) under ablations that isolate the per-keyframe costs:

  full     production config (onehot matchers + dense fills, optimize 3/3)
  opt1     incremental optimize: 1 GN iteration per keyframe, 3 after a loop
  opt0     no pose-graph optimization (cost floor of the solve)
  noloop   closure search disabled (cost of rasterize+match+accept machinery)
  k128     max_keyframes 128 (dense solve is [3K, 3K]: half K, ~1/4 solve)

Usage: python scripts/profile_graph.py [--scans 512]
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=512)
    ap.add_argument("--platform", choices=["cpu", "gpu"], default="gpu")
    args = ap.parse_args()
    from slamnet_tpu.runtime import select_platform, setup_compile_cache
    select_platform(args.platform)
    setup_compile_cache()
    import jax
    import numpy as np
    import jax.numpy as jnp

    from slamnet_tpu.core import (HectorConfig, PoseGraphConfig, SimConfig)
    from slamnet_tpu.core.scan import Scan
    from slamnet_tpu.graph import frontend
    from slamnet_tpu.models import graph_slam
    from slamnet_tpu.sim import default_field, lidar
    from slamnet_tpu.sim.trajectory import rect_revisit_trajectory

    sim = SimConfig()
    n_scans, bootstrap = args.scans, 12
    hcfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4),
                        matcher_mode="onehot_bf16", dense_free_fill=True)
    mcfg = frontend.ScanMatchConfig(matcher_mode="onehot_bf16",
                                    dense_fill=True)
    gcfg = PoseGraphConfig()

    drive = rect_revisit_trajectory(num_loops=2)
    take = n_scans - bootstrap
    still = np.tile(np.asarray([20.0, 20.0, 0.0], np.float32), (bootstrap, 1))
    traj = np.concatenate([still, drive[:take]])

    fld = default_field()
    angles = jnp.asarray(lidar.revolution_angles(sim.num_scan_points))

    @jax.jit
    def genlog(poses, key):
        keys = jax.random.split(key, poses.shape[0])

        def one(p, k):
            return lidar.scan_revolution(fld, p, angles, sim.max_scan_dist,
                                         sim.measure_error, k)
        return jax.vmap(one)(poses, keys)

    radii, valids = genlog(jnp.asarray(traj), jax.random.PRNGKey(7))
    force = jnp.arange(n_scans) < bootstrap

    def run(gcfg_x, mcfg_x=mcfg):
        state = graph_slam.init(hcfg, gcfg_x, traj[0], int(angles.shape[0]))

        @jax.jit
        def replay(state, radii, valids, force):
            def body(st, inp):
                rr, vv, f = inp
                pts = jnp.stack([rr * jnp.cos(angles),
                                 rr * jnp.sin(angles)], -1)
                st, _ = graph_slam.update(
                    st, Scan(pts, vv, jnp.zeros(3, jnp.float32)), hcfg,
                    gcfg_x, mcfg=mcfg_x, map_without_matching=f)
                return st, st.hector.match_pose
            return jax.lax.scan(body, state, (radii, valids, force))

        stf, poses = replay(state, radii, valids, force)
        jax.block_until_ready(stf)
        best = float("inf")
        for _ in range(3):
            t0 = time.time()
            stf, poses = replay(state, radii, valids, force)
            jax.block_until_ready(stf)
            best = min(best, time.time() - t0)
        err = np.asarray(poses)[bootstrap:] - traj[bootstrap:]
        pe = np.linalg.norm(err[:, :2], axis=1)
        return (n_scans / best, float(np.sqrt((pe ** 2).mean())),
                int(np.asarray(stf.graph.num_nodes)),
                int(np.asarray(stf.loop_count)))

    variants = {
        "full": gcfg,
        "opt1": dataclasses.replace(gcfg, optimize_iterations=1,
                                    optimize_iterations_loop=3),
        "opt0": dataclasses.replace(gcfg, optimize_iterations=0,
                                    optimize_iterations_loop=0),
        "noloop": dataclasses.replace(gcfg, loop_closure_radius=1e-3),
        "k128": dataclasses.replace(gcfg, max_keyframes=128, max_edges=512),
        "k128_opt1": dataclasses.replace(gcfg, max_keyframes=128,
                                         max_edges=512,
                                         optimize_iterations=1,
                                         optimize_iterations_loop=3),
    }
    print(f"{'variant':>10} {'scans/s':>8} {'ate_m':>7} {'kf':>4} {'loops':>5}")
    for name, g in variants.items():
        rate, ate, kf, loops = run(g)
        print(f"{name:>10} {rate:>8.1f} {ate:>7.4f} {kf:>4} {loops:>5}")


if __name__ == "__main__":
    main()
