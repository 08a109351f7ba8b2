#!/usr/bin/env python
"""Fleet update-capacity ablation — the in-tree reproduction of the round-3
table that changed the default to UNCAPPED updates (PERF.md: deferral
bursts leave instances matching against stale maps; cap=8 cost 27x the
median-instance ATE for ~25% more throughput).

Sweeps fleet_update_capacity over {8, 16, 32, uncapped} at B=64, T=256
(the horizon the round-3 ablation used — the driver bench's T=64 slices are
too short to surface the compounding staleness error), production config
(subsample 4, one-hot matcher, xy clamp + match-jump guards).

Usage: python scripts/bench_fleet_capacity.py [--batch 64] [--scans 256]
"""
import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--scans", type=int, default=256)
    ap.add_argument("--platform", choices=["cpu", "gpu"], default="gpu")
    ap.add_argument("--capacities", default="8,16,32,0",
                    help="comma list; 0 = uncapped (the default config)")
    ap.add_argument("--damping", type=float, default=0.1,
                    help="gn_damping (Levenberg diag scaling; the serving "
                         "profile default — core/config.py "
                         "serving_hector_config; pass 0 for the raw "
                         "reference-parity solve)")
    args = ap.parse_args()

    from slamnet_tpu.runtime import select_platform, setup_compile_cache
    select_platform(args.platform)
    setup_compile_cache()
    import jax
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from slamnet_tpu.core import HectorConfig, SimConfig
    from slamnet_tpu.models import fleet
    from slamnet_tpu.sim import default_field, lidar
    from slamnet_tpu.sim.trajectory import loop_trajectory

    from slamnet_tpu.core.config import serving_hector_config
    base = serving_hector_config(gn_damping=args.damping)
    sim = SimConfig()
    B, T = args.batch, args.scans
    boot = 10

    cpu = jax.devices("cpu")[0]
    fld = default_field()
    angles_np = lidar.revolution_angles(sim.num_scan_points)
    full = loop_trajectory(speed=0.3)
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

    print(f"B={B} T={T} sub4 onehot_bf16 guards=on")
    print(f"{'capacity':>10} {'inst-scans/s':>13} {'ate_rms':>8} "
          f"{'ate_median':>10} {'ate_max':>8}")
    for cap_s in args.capacities.split(","):
        cap = int(cap_s)
        cfg = (base if cap == 0
               else dataclasses.replace(base, fleet_update_capacity=cap))

        states = fleet.init_fleet(cfg, traj[:, 0])

        @jax.jit
        def boot_step(states, r, v, poses, cfg=cfg):
            pts = jnp.stack([r * jnp.cos(angles)[None],
                             r * jnp.sin(angles)[None]], -1)
            states = states._replace(match_pose=poses)
            states, _ = fleet.update_fleet(states, pts, v, cfg,
                                           map_without_matching=True)
            return states

        for t in range(boot):
            states = boot_step(states, radii[t], valids[t], traj_d[t])
        jax.block_until_ready(states)

        replay = jax.jit(
            lambda s, r, v, cfg=cfg: fleet.replay_fleet(s, r, v, angles, cfg))
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
        inst_ate = np.sqrt((pe ** 2).mean(axis=0))          # per-instance [B]
        print(f"{cap_s if cap else 'uncapped':>10} {T * B / best:>13.1f} "
              f"{np.sqrt((pe ** 2).mean()):>8.4f} "
              f"{np.median(inst_ate):>10.4f} {pe.max():>8.3f}")


if __name__ == "__main__":
    main()
