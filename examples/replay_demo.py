#!/usr/bin/env python
"""Trajectory-replay demo: simulator -> SLAM pipelines -> ATE report.

The headless equivalent of the reference's Simulation app (MainWindow.xaml.cs):
drives scripted trajectories through the default field, feeds noisy lidar
revolutions to the pipelines, and reports pose error against ground truth —
the divergence oracle (MainWindow.xaml.cs:182-196) as a CLI.

Usage:
  python examples/replay_demo.py --scans 200 --platform cpu --pipeline coreslam
  python examples/replay_demo.py --pipeline hector          # once hector lands
"""
import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=200)
    ap.add_argument("--platform", choices=["cpu", "gpu"], default="cpu")
    ap.add_argument("--pipeline",
                    choices=["coreslam", "hector", "particle", "graph", "both",
                             "all"],
                    default="coreslam")
    ap.add_argument("--trajectory",
                    choices=["loop", "stationary", "spin", "office"],
                    default="loop",
                    help="'office' drives the multi-room office world "
                         "(sim/field.office_field) instead of the default "
                         "field — the loop-closure benchmark scenario")
    ap.add_argument("--speed", type=float, default=0.3)
    ap.add_argument("--candidates", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-ray dropout probability (fault injection)")
    ap.add_argument("--render", metavar="DIR", default=None,
                    help="save final map/pose PNGs to DIR")
    ap.add_argument("--metrics", metavar="FILE", default=None,
                    help="write per-scan ScanMetrics JSONL (hector pipeline)")
    ap.add_argument("--html", metavar="FILE", default=None,
                    help="write a self-contained HTML live replay "
                         "(hector pipeline: map levels + pose overlays)")
    args = ap.parse_args()

    from slamnet_tpu.runtime import select_platform
    select_platform(args.platform)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slamnet_tpu.core import CoreSlamConfig, HectorConfig, SimConfig
    from slamnet_tpu.core.scan import Scan
    from slamnet_tpu.models import coreslam
    from slamnet_tpu.sim import default_field, lidar
    from slamnet_tpu.sim import trajectory as trj

    sim = SimConfig()
    if args.trajectory == "office":
        from slamnet_tpu.sim.field import office_field
        fld = office_field()
    else:
        fld = default_field()
    angles = jnp.asarray(lidar.revolution_angles(sim.num_scan_points))

    traj = {
        "loop": lambda: trj.loop_trajectory(speed=args.speed),
        "stationary": lambda: trj.stationary_trajectory(num_scans=args.scans),
        "spin": lambda: trj.spin_trajectory(num_scans=args.scans),
        "office": lambda: trj.office_tour_trajectory(num_loops=1),
    }[args.trajectory]()[: args.scans]
    print(f"trajectory: {args.trajectory}, {traj.shape[0]} scans @ {sim.scans_per_second} Hz")

    key = jax.random.PRNGKey(args.seed)
    results = {}

    if args.pipeline in ("coreslam", "both", "all"):
        cfg = CoreSlamConfig(num_candidates=args.candidates)
        state = coreslam.init(cfg, traj[0], key=jax.random.PRNGKey(args.seed + 1))

        @jax.jit
        def cs_step(state, real_pose, key):
            radii, valid = lidar.scan_revolution(
                fld, real_pose, angles, sim.max_scan_dist, sim.measure_error, key,
                dropout_prob=args.dropout)
            pts = jnp.stack([radii * jnp.cos(angles), radii * jnp.sin(angles)], -1)
            cloud = Scan(pts, valid, jnp.zeros(3, jnp.float32))
            return coreslam.update_cloud(state, cloud, state.pose, cfg)

        errs = []
        t0 = time.time()
        for t in range(traj.shape[0]):
            key, sub = jax.random.split(key)
            state, info = cs_step(state, jnp.asarray(traj[t]), sub)
            errs.append(np.asarray(state.pose) - traj[t])
        jax.block_until_ready(state)
        dt = time.time() - t0
        errs = np.asarray(errs)
        pos = np.linalg.norm(errs[:, :2], axis=1)
        results["coreslam"] = dict(
            ate=float(np.sqrt((pos ** 2).mean())), max_err=float(pos.max()),
            max_ang_deg=float(np.degrees(np.abs(errs[:, 2])).max()),
            scans_per_sec=traj.shape[0] / dt)

    if args.pipeline in ("particle", "all"):
        from slamnet_tpu.core import ParticleConfig
        from slamnet_tpu.models import particle
        ccfg = CoreSlamConfig()
        pcfg = ParticleConfig(num_particles=2048, top_k=32,
                              refine_candidates=32)
        pstate = particle.init(ccfg, pcfg, traj[0],
                               key=jax.random.PRNGKey(args.seed + 2))

        @jax.jit
        def p_step(state, real_pose, key):
            radii, valid = lidar.scan_revolution(
                fld, real_pose, angles, sim.max_scan_dist, sim.measure_error, key,
                dropout_prob=args.dropout)
            pts = jnp.stack([radii * jnp.cos(angles), radii * jnp.sin(angles)], -1)
            cloud = Scan(pts, valid, jnp.zeros(3, jnp.float32))
            return particle.update(state, cloud, state.pose, ccfg, pcfg)

        errs = []
        t0 = time.time()
        for t in range(traj.shape[0]):
            key, sub = jax.random.split(key)
            pstate, pinfo = p_step(pstate, jnp.asarray(traj[t]), sub)
            errs.append(np.asarray(pstate.pose) - traj[t])
        jax.block_until_ready(pstate)
        dt = time.time() - t0
        errs = np.asarray(errs)
        pos = np.linalg.norm(errs[:, :2], axis=1)
        results["particle"] = dict(
            ate=float(np.sqrt((pos ** 2).mean())), max_err=float(pos.max()),
            max_ang_deg=float(np.degrees(np.abs(errs[:, 2])).max()),
            scans_per_sec=traj.shape[0] / dt)

    if args.pipeline in ("graph", "all"):
        from slamnet_tpu.core import PoseGraphConfig
        from slamnet_tpu.models import graph_slam
        hcfg = HectorConfig()
        gcfg = PoseGraphConfig(max_keyframes=64, max_edges=256,
                               keyframe_dist=1.0, keyframe_angle=0.6)
        gstate = graph_slam.init(hcfg, gcfg, traj[0], len(angles))

        @jax.jit
        def g_step(state, real_pose, key, boot):
            radii, valid = lidar.scan_revolution(
                fld, real_pose, angles, sim.max_scan_dist, sim.measure_error, key,
                dropout_prob=args.dropout)
            pts = jnp.stack([radii * jnp.cos(angles), radii * jnp.sin(angles)], -1)
            cloud = Scan(pts, valid, jnp.zeros(3, jnp.float32))
            # bootstrap maps at the TRUE pose (see the hector step)
            state = state._replace(hector=state.hector._replace(
                match_pose=jnp.where(boot, real_pose,
                                     state.hector.match_pose)))
            return graph_slam.update(state, cloud, hcfg, gcfg,
                                     map_without_matching=boot)

        errs, nloops = [], 0
        t0 = time.time()
        for t in range(traj.shape[0]):
            key, sub = jax.random.split(key)
            gstate, ginfo = g_step(gstate, jnp.asarray(traj[t]), sub,
                                   jnp.asarray(t < 10))
            errs.append(np.asarray(gstate.hector.match_pose) - traj[t])
        jax.block_until_ready(gstate)
        dt = time.time() - t0
        errs = np.asarray(errs)
        pos = np.linalg.norm(errs[:, :2], axis=1)
        results["graph"] = dict(
            ate=float(np.sqrt((pos ** 2).mean())), max_err=float(pos.max()),
            max_ang_deg=float(np.degrees(np.abs(errs[:, 2])).max()),
            scans_per_sec=traj.shape[0] / dt)
        print(f"graph: {int(gstate.graph.num_nodes)} keyframes, "
              f"{int(gstate.graph.num_edges)} edges, "
              f"{int(gstate.loop_count)} loop closures")

    if args.pipeline in ("hector", "both", "all"):
        try:
            from slamnet_tpu.models import hector
        except ImportError:
            print("hector pipeline not yet available", file=sys.stderr)
            sys.exit(2)
        hcfg = HectorConfig()
        hstate = hector.init(hcfg, traj[0])

        @jax.jit
        def h_step(state, real_pose, key, bootstrap):
            radii, valid = lidar.scan_revolution(
                fld, real_pose, angles, sim.max_scan_dist, sim.measure_error, key,
                dropout_prob=args.dropout)
            pts = jnp.stack([radii * jnp.cos(angles), radii * jnp.sin(angles)], -1)
            cloud = Scan(pts, valid, jnp.zeros(3, jnp.float32))
            # bootstrap scans map at the TRUE pose (the bench-harness
            # pattern): a moving robot would otherwise rasterize its first
            # scans at a frozen pose and corrupt the map (fatal for the
            # office tour's 0.25 m/scan start)
            hint = jnp.where(bootstrap, real_pose, state.match_pose)
            return hector.update(state, cloud, hint, hcfg,
                                 map_without_matching=bootstrap)

        # first-class observability: structured per-scan records, the ring
        # log, and the simulator's divergence oracle (io/metrics.py)
        from slamnet_tpu.io.metrics import (DivergenceMonitor, EmaTimer,
                                            RingLog, ScanMetrics)
        ring = RingLog()
        monitor = DivergenceMonitor(log=ring)
        match_ema = EmaTimer()
        records = []
        recorder = None
        if args.html:
            from slamnet_tpu.io.live import ReplayRecorder
            recorder = ReplayRecorder(hcfg, every=max(1, traj.shape[0] // 100))

        errs = []
        t0 = time.time()
        for t in range(traj.shape[0]):
            key, sub = jax.random.split(key)
            with match_ema.time():
                hstate, hinfo = h_step(hstate, jnp.asarray(traj[t]), sub,
                                       jnp.asarray(t < 10))
                jax.block_until_ready(hstate.match_pose)
            errs.append(np.asarray(hstate.match_pose) - traj[t])
            records.append(ScanMetrics(
                scan_index=t,
                pose=tuple(float(v) for v in np.asarray(hstate.match_pose)),
                match_ms=match_ema.ms,
                map_updated=bool(hinfo.map_updated),
                gn_residual=float(hinfo.residual)))
            ring.log(f"scan {t}: resid {float(hinfo.residual):.4f} "
                     f"fails {int(hinfo.solve_failures)}")
            if monitor.check(t, np.asarray(hstate.match_pose), traj[t]):
                print("\n".join(monitor.report), file=sys.stderr)
            if recorder is not None:
                recorder.add(t, hstate.maps, hstate.match_pose, traj[t])
        jax.block_until_ready(hstate)
        dt = time.time() - t0
        errs = np.asarray(errs)
        pos = np.linalg.norm(errs[:, :2], axis=1)
        upd = sum(1 for r in records if r.map_updated)
        results["hector"] = dict(
            ate=float(np.sqrt((pos ** 2).mean())), max_err=float(pos.max()),
            max_ang_deg=float(np.degrees(np.abs(errs[:, 2])).max()),
            scans_per_sec=traj.shape[0] / dt)
        print(f"hector: {upd} map updates, match EMA {match_ema.ms:.2f} ms, "
              f"final residual {records[-1].gn_residual:.4f}"
              + (f", DIVERGED at {monitor.diverged_at}"
                 if monitor.diverged_at is not None else ""))
        if args.metrics:
            import dataclasses as _dc
            import json as _json
            with open(args.metrics, "w") as f:
                for r in records:
                    f.write(_json.dumps(_dc.asdict(r)) + "\n")
            print(f"wrote {len(records)} ScanMetrics records to {args.metrics}")
        if recorder is not None:
            recorder.write(args.html,
                           title=f"HectorSLAM replay - {args.trajectory}")
            print(f"wrote HTML replay ({len(recorder.frames)} frames) "
                  f"to {args.html}")

    if args.render:
        os.makedirs(args.render, exist_ok=True)
        from slamnet_tpu.io import viz
        edges = (np.asarray(fld.a), np.asarray(fld.b))
        real = traj[-1]
        if "coreslam" in results:
            viz.render_frame(
                os.path.join(args.render, "coreslam.png"),
                hole_map=state.hole_map, hole_size=cfg.hole_map_size,
                physical_size=cfg.physical_map_size, field_edges=edges,
                real_pose=real,
                estimates={"coreslam": (np.asarray(state.pose), "blue")},
                trajectory=traj, title="(final)")
        if "hector" in results or "graph" in results:
            from slamnet_tpu.models import hector as hx
            hs = gstate.hector if "graph" in results else hstate
            viz.render_frame(
                os.path.join(args.render, "hector.png"),
                logodds=hx.level_view(hs.maps, hcfg, 0).reshape(-1),
                occ_size=hcfg.map_size,
                physical_size=hcfg.map_size * hcfg.map_resolution,
                field_edges=edges, real_pose=real,
                estimates={"hector": (np.asarray(hs.match_pose), "green")},
                trajectory=traj, title="(level 0, final)")
        print(f"rendered PNGs to {args.render}")

    ok = True
    for name, r in results.items():
        status = "OK" if (r["max_err"] < 1.0 and r["max_ang_deg"] < 10.0) else "DIVERGED"
        ok &= status == "OK"
        print(f"{name}: ATE={r['ate']:.3f} m  max_err={r['max_err']:.3f} m  "
              f"max_ang={r['max_ang_deg']:.2f} deg  rate={r['scans_per_sec']:.1f} scans/s  "
              f"[{status}]")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
