#!/usr/bin/env python
"""Fleet-mode throughput: B batched Hector instances vs one unbatched instance.

Early finding: the all-vmap fleet ran 10x slower per instance than one
instance, because vmap lowers the motion gate to select and every instance
pays the occupancy scatter every scan.  Round-2 fix: vmapped matching + lax.scan over instances with a REAL
lax.cond per instance (models/fleet.py).

Each instance replays a phase-shifted slice of the bench loop trajectory, so
motion gates fire desynchronized at the reference's ~1-in-18 statistics.

Usage: python scripts/bench_fleet.py [--batch 64] [--scans 128]
"""
import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--scans", type=int, default=128)
    ap.add_argument("--platform", choices=["cpu", "gpu"], default="gpu")
    ap.add_argument("--dense", action="store_true",
                    help="dense polar free-fill updates (faster than line "
                         "scatter under the fleet update scan)")
    ap.add_argument("--subsample", type=int, default=4,
                    help="matcher beam subsample (map updates keep all beams)")
    ap.add_argument("--capacity", type=int, default=8,
                    help="gated map-update budget per batch-scan")
    ap.add_argument("--damping", type=float, default=0.0,
                    help="Levenberg diagonal damping (gn_damping)")
    args = ap.parse_args()

    from slamnet_tpu.runtime import select_platform, setup_compile_cache
    select_platform(args.platform)
    setup_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slamnet_tpu.core import HectorConfig, SimConfig
    from slamnet_tpu.models import fleet, hector
    from slamnet_tpu.core.scan import Scan
    from slamnet_tpu.sim import default_field, lidar
    from slamnet_tpu.sim.trajectory import loop_trajectory

    # production serving config: translation step clamp on (two trajectory
    # slices bootstrap at a degenerate top-corridor view where an unclamped GN
    # step throws the pose off-map; the clamp bounds them — see PERF.md)
    cfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4),
                       xy_step_clamp_px=10.0, match_subsample=args.subsample,
                       dense_free_fill=args.dense,
                       fleet_update_capacity=args.capacity,
                       gn_damping=args.damping)
    sim = SimConfig()
    B, T = args.batch, args.scans
    boot = 10

    # --- scan log on the host CPU backend ------------------------------------
    cpu = jax.devices("cpu")[0]
    fld = default_field()
    angles_np = lidar.revolution_angles(sim.num_scan_points)
    full = loop_trajectory(speed=0.3)
    # phase-shifted per-instance trajectory slices
    starts = np.linspace(0, len(full) - (T + boot), B).astype(int)
    traj = np.stack([full[s:s + T + boot] for s in starts])  # [B, T+boot, 3]

    with jax.default_device(cpu):
        fld_c = jax.tree.map(lambda x: jax.device_put(x, cpu), fld)
        angles_c = jax.device_put(jnp.asarray(angles_np), cpu)

        @jax.jit
        def genlog(poses, key):
            keys = jax.random.split(key, poses.shape[0])

            def one(p, k):
                return lidar.scan_revolution(fld_c, p, angles_c,
                                             sim.max_scan_dist,
                                             sim.measure_error, k)
            return jax.vmap(one)(poses, keys)

        flat = traj.reshape(-1, 3)
        radii_c, valid_c = genlog(jax.device_put(jnp.asarray(flat), cpu),
                                  jax.device_put(jax.random.PRNGKey(0), cpu))
    radii = np.asarray(radii_c).reshape(B, T + boot, -1).transpose(1, 0, 2)
    valids = np.asarray(valid_c).reshape(B, T + boot, -1).transpose(1, 0, 2)

    dev = jax.devices()[0]
    radii = jax.device_put(radii, dev)          # [T+boot, B, N]
    valids = jax.device_put(valids, dev)
    angles = jax.device_put(jnp.asarray(angles_np), dev)
    traj_d = jax.device_put(jnp.asarray(traj.transpose(1, 0, 2)), dev)

    # --- bootstrap: forced updates at ground-truth poses ----------------------
    states = fleet.init_fleet(cfg, traj[:, 0])

    @jax.jit
    def boot_step(states, r, v, poses):
        pts = jnp.stack([r * jnp.cos(angles)[None], r * jnp.sin(angles)[None]],
                        -1)
        states = states._replace(match_pose=poses)
        states, _ = fleet.update_fleet(states, pts, v, cfg,
                                       map_without_matching=True)
        return states

    for t in range(boot):
        states = boot_step(states, radii[t], valids[t], traj_d[t])
    jax.block_until_ready(states)

    # --- timed replay ---------------------------------------------------------
    replay = jax.jit(lambda s, r, v: fleet.replay_fleet(s, r, v, angles, cfg))
    stf, poses = replay(states, radii[boot:], valids[boot:])
    jax.block_until_ready(stf)
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        stf, poses = replay(states, radii[boot:], valids[boot:])
        jax.block_until_ready(stf)
        best = min(best, time.time() - t0)

    err = np.asarray(poses) - traj.transpose(1, 0, 2)[boot:]
    pe = np.linalg.norm(err[:, :, :2], axis=-1)
    inst_rate = T * B / best

    # --- single-instance baseline (same machinery, B=1 slice) ----------------
    single = hector.init(cfg, traj[0, 0])

    @jax.jit
    def boot1(st, r, v, p):
        pts = jnp.stack([r * jnp.cos(angles), r * jnp.sin(angles)], -1)
        st, _ = hector.update(st, Scan(pts, v, jnp.zeros(3, jnp.float32)), p,
                              cfg, map_without_matching=jnp.asarray(True))
        return st

    for t in range(boot):
        single = boot1(single, radii[t, 0], valids[t, 0], traj_d[t, 0])

    @jax.jit
    def replay1(st, rr, vv):
        def body(s, inp):
            r, v = inp
            pts = jnp.stack([r * jnp.cos(angles), r * jnp.sin(angles)], -1)
            s, _ = hector.update(s, Scan(pts, v, jnp.zeros(3, jnp.float32)),
                                 s.match_pose, cfg,
                                 map_without_matching=jnp.asarray(False))
            return s, s.match_pose
        return jax.lax.scan(body, st, (rr, vv))

    st1, _ = replay1(single, radii[boot:, 0], valids[boot:, 0])
    jax.block_until_ready(st1)
    best1 = float("inf")
    for _ in range(3):
        t0 = time.time()
        st1, _ = replay1(single, radii[boot:, 0], valids[boot:, 0])
        jax.block_until_ready(st1)
        best1 = min(best1, time.time() - t0)
    single_rate = T / best1

    print(f"device: {jax.devices()[0]}")
    print(f"B={B} T={T}  fleet: {inst_rate:.0f} instance-scans/s "
          f"({T / best:.1f} batch-scans/s)")
    print(f"single instance: {single_rate:.0f} scans/s")
    print(f"fleet/single ratio: {inst_rate / single_rate:.2f}x "
          f"(target >= 5x)")
    print(f"fleet ATE: {np.sqrt((pe ** 2).mean()):.4f} m  max {pe.max():.4f} m")
    per_inst = pe.max(axis=0)
    worst = np.argsort(per_inst)[-5:][::-1]
    print("worst instances (idx, start, max_err):",
          [(int(i), int(starts[i]), round(float(per_inst[i]), 3))
           for i in worst])


if __name__ == "__main__":
    main()
