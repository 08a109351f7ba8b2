#!/usr/bin/env python
"""Replay a standard 2D lidar dataset (CARMEN log format) through the SLAM
pipelines — the real-robot ingestion path (reference:
CoreSLAMProcessor.cs:717 consumes arbitrary ScanSegment streams;
north star: "standard 2D lidar datasets").

    python examples/replay_dataset.py --log examples/data/sim_loop.clf \
        --out-dir /tmp/dataset_out --platform cpu

Reads FLASER/ROBOTLASER1 scans + odometry, recenters the world on the first
odometry pose (CARMEN coordinates are arbitrary; the maps span
[0, map_size_m]), replays BOTH pipelines with the odometry delta as the
motion prior, and writes a pose-track JSONL + hole-map / occupancy PNGs.
"""
import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "data", "sim_loop.clf"))
    ap.add_argument("--out-dir", default="/tmp/slamnet_dataset")
    ap.add_argument("--max-scans", type=int, default=None)
    ap.add_argument("--map-size-m", type=float, default=40.0)
    ap.add_argument("--platform", choices=["cpu", "gpu"], default="cpu")
    ap.add_argument("--robust", action="store_true",
                    help="enable the production robustness guards "
                         "(xy step clamp, match-jump reject, GN damping) — "
                         "recommended for degraded logs with odometry slips "
                         "(examples/data/adversarial_180.clf)")
    args = ap.parse_args()

    from slamnet_tpu.runtime import select_platform
    select_platform(args.platform)
    import jax
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from slamnet_tpu.core import CoreSlamConfig, HectorConfig
    from slamnet_tpu.core.scan import Scan
    from slamnet_tpu.io import datasets, viz
    from slamnet_tpu.models import coreslam, hector

    # prefer the native parser (native/slamnet_host.cpp, bit-identical to the
    # Python reader — tests/test_hostio.py); fall back when no toolchain
    from slamnet_tpu import hostio
    log = hostio.read_carmen_native(args.log, max_scans=args.max_scans)
    used_native = log is not None
    if log is None:
        log = datasets.read_carmen(args.log, max_scans=args.max_scans)
    T, N = log.ranges.shape
    pts_all = datasets.log_points(log)

    # recenter: first odometry pose -> map center
    center = args.map_size_m / 2.0
    offset = log.odometry[0, :2] - center
    odo = log.odometry.copy()
    odo[:, :2] -= offset[None, :]

    ccfg = dataclasses.replace(
        CoreSlamConfig(), physical_map_size=args.map_size_m,
        search_mode="correlative", dense_hole_fill=True,
        dense_obstacle_fill=True)
    hcfg = dataclasses.replace(
        HectorConfig(), num_levels=3, estimate_iterations=(7, 4, 4),
        map_resolution=args.map_size_m / 400.0)
    if args.robust:
        # measured on adversarial_180.clf: rms/max ATE 0.112/2.050 without
        # guards -> 0.034/0.234 with (PERF.md dataset section)
        hcfg = dataclasses.replace(hcfg, xy_step_clamp_px=10.0,
                                   max_match_jump=1.0, gn_damping=0.1)

    cstate = coreslam.init(ccfg, odo[0])
    hstate = hector.init(hcfg, odo[0])

    @jax.jit
    def cstep(st, p, v, o):
        return coreslam.update_cloud(st, Scan(p, v, jnp.zeros(3, jnp.float32)),
                                     o, ccfg)

    @jax.jit
    def hstep(st, p, v, hint, force):
        return hector.update(st, Scan(p, v, jnp.zeros(3, jnp.float32)), hint,
                             hcfg, map_without_matching=force)

    truth = None
    if log.truth is not None:
        truth = log.truth.copy()
        truth[:, :2] -= offset[None, :]

    os.makedirs(args.out_dir, exist_ok=True)
    track_path = os.path.join(args.out_dir, "track.jsonl")
    t0 = time.time()
    prev_odo = odo[0]
    ctrack, htrack = [], []
    with open(track_path, "w") as tf:
        for t in range(T):
            p = jnp.asarray(pts_all[t])
            v = jnp.asarray(log.valid[t])
            cstate, _ = cstep(cstate, p, v, jnp.asarray(odo[t]))
            # Hector prior: previous match pose + odometry delta
            delta = odo[t] - prev_odo
            delta[2] = math.remainder(delta[2], 2.0 * math.pi)
            hint = np.asarray(hstate.match_pose) + delta
            hstate, _ = hstep(hstate, p, v, jnp.asarray(hint, jnp.float32),
                              jnp.asarray(t < 10))
            if t < 10:
                hstate = hstate._replace(
                    match_pose=jnp.asarray(odo[t], jnp.float32))
            prev_odo = odo[t]
            ctrack.append(np.asarray(cstate.pose))
            htrack.append(np.asarray(hstate.match_pose))
            tf.write(json.dumps({
                "t": t, "odom": [round(float(x), 4) for x in odo[t]],
                "coreslam": [round(float(x), 4) for x in np.asarray(cstate.pose)],
                "hector": [round(float(x), 4)
                           for x in np.asarray(hstate.match_pose)],
            }) + "\n")
    dt = time.time() - t0

    hole_png = os.path.join(args.out_dir, "hole_map.png")
    occ_png = os.path.join(args.out_dir, "occupancy.png")
    viz.render_frame(hole_png, hole_map=np.asarray(cstate.hole_map),
                     hole_size=ccfg.hole_map_size,
                     physical_size=args.map_size_m,
                     estimates={"coreslam": (np.asarray(cstate.pose),
                                             "tab:blue")},
                     title=os.path.basename(args.log) + " (hole map)")
    viz.render_frame(occ_png,
                     logodds=np.asarray(hstate.maps[:hcfg.map_size ** 2]),
                     occ_size=hcfg.map_size,
                     physical_size=args.map_size_m,
                     estimates={"hector": (np.asarray(hstate.match_pose),
                                           "tab:green")},
                     title=os.path.basename(args.log) + " (occupancy)")

    cdrift = float(np.linalg.norm(np.asarray(cstate.pose)[:2] - odo[-1][:2]))
    hdrift = float(np.linalg.norm(
        np.asarray(hstate.match_pose)[:2] - odo[-1][:2]))
    print(f"{T} scans x {N} beams in {dt:.1f}s ({T / dt:.1f} scans/s)"
          f"  [{'native' if used_native else 'python'} parser]")
    print(f"final vs odometry: coreslam {cdrift:.3f} m, hector {hdrift:.3f} m")
    if truth is not None:
        # the log embeds ground truth ("# TRUTH" lines): report real ATE
        def ate(track):
            pe = np.linalg.norm(np.asarray(track)[:, :2] - truth[:, :2],
                                axis=1)
            return float(np.sqrt((pe ** 2).mean())), float(pe.max())
        oate, omax = ate(odo)
        cate, cmax = ate(ctrack)
        hate, hmax = ate(htrack)
        print(f"ATE vs truth (rms/max m): odometry-only {oate:.3f}/{omax:.3f}"
              f"  coreslam {cate:.3f}/{cmax:.3f}"
              f"  hector {hate:.3f}/{hmax:.3f}")
    print(f"track: {track_path}")
    print(f"maps:  {hole_png}  {occ_png}")


if __name__ == "__main__":
    main()
