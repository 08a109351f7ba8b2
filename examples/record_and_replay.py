#!/usr/bin/env python
"""Dataset round-trip: record simulator scans to .slog, replay SLAM from the file.

Demonstrates the full host data path (SURVEY.md §2.5 P6): simulator -> native
scan-log writer -> ScanQueue handoff (producer thread reading the file, consumer
feeding the device) -> jitted SLAM steps -> ATE report.

Usage:
  python examples/record_and_replay.py --scans 200 --platform cpu
"""
import argparse
import os
import struct
import sys
import threading
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=200)
    ap.add_argument("--platform", choices=["cpu", "gpu"], default="cpu")
    ap.add_argument("--out", default="/tmp/slamnet_demo.slog")
    args = ap.parse_args()

    from slamnet_tpu.runtime import select_platform
    select_platform(args.platform)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slamnet_tpu import hostio
    from slamnet_tpu.core import HectorConfig, SimConfig
    from slamnet_tpu.core.scan import Scan
    from slamnet_tpu.models import hector
    from slamnet_tpu.sim import default_field, lidar
    from slamnet_tpu.sim.trajectory import loop_trajectory

    if hostio.load_library() is None:
        print("native library unavailable (no toolchain)", file=sys.stderr)
        return 2

    sim = SimConfig()
    fld = default_field()
    angles = jnp.asarray(lidar.revolution_angles(sim.num_scan_points))
    n = len(angles)
    traj = loop_trajectory(speed=0.3)[: args.scans]

    # ---- record: simulate and write the scan log
    t0 = time.time()
    w = hostio.SlogWriter(args.out, n)
    key = jax.random.PRNGKey(0)
    scan_fn = jax.jit(lambda pose, k: lidar.scan_revolution(
        fld, pose, angles, sim.max_scan_dist, sim.measure_error, k))
    for t in range(traj.shape[0]):
        key, sub = jax.random.split(key)
        radii, valid = scan_fn(jnp.asarray(traj[t]), sub)
        w.append(int(t * 1e9 / 17), traj[t], np.asarray(radii),
                 np.asarray(valid))
    w.close()
    size_kb = os.path.getsize(args.out) / 1024
    print(f"recorded {traj.shape[0]} scans -> {args.out} "
          f"({size_kb:.0f} KB) in {time.time()-t0:.1f}s")

    # ---- replay: producer thread reads the log into the native queue,
    #      consumer feeds the jitted pipeline
    slot = 8 + 12 + 4 * n + n  # ts + odom + radii + valid bytes
    q = hostio.ScanQueue(capacity=8, slot_bytes=slot)

    def producer():
        for ts, odom, radii, valid in hostio.SlogReader(args.out):
            buf = (struct.pack("<Q", ts) + odom.tobytes() + radii.tobytes()
                   + valid.astype(np.uint8).tobytes())
            q.push(buf, timeout_ms=5000)
        q.close()

    threading.Thread(target=producer, daemon=True).start()

    cfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4))
    state = hector.init(cfg, traj[0])
    step = jax.jit(lambda st, pts, v, boot: hector.update(
        st, Scan(pts, v, jnp.zeros(3, jnp.float32)), st.match_pose, cfg,
        map_without_matching=boot))

    errs, t_idx = [], 0
    t0 = time.time()
    while True:
        item = q.pop(timeout_ms=5000)
        if item is None:
            break
        odom = np.frombuffer(item, np.float32, 3, offset=8)
        radii = np.frombuffer(item, np.float32, n, offset=20)
        valid = np.frombuffer(item, np.uint8, n, offset=20 + 4 * n).astype(bool)
        pts = np.stack([radii * np.cos(np.asarray(angles)),
                        radii * np.sin(np.asarray(angles))], -1)
        state, _ = step(state, jnp.asarray(pts), jnp.asarray(valid),
                        jnp.asarray(t_idx < 10))
        errs.append(np.asarray(state.match_pose) - odom)
        t_idx += 1
    jax.block_until_ready(state)
    dt = time.time() - t0
    errs = np.asarray(errs)
    pos = np.linalg.norm(errs[:, :2], axis=1)
    ok = pos.max() < 1.0
    print(f"replayed {t_idx} scans from log: ATE={np.sqrt((pos**2).mean()):.3f} m "
          f"max={pos.max():.3f} m rate={t_idx/dt:.1f} scans/s "
          f"dropped={q.dropped} [{'OK' if ok else 'DIVERGED'}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
