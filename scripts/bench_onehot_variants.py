#!/usr/bin/env python
"""One-hot matcher micro-variants (round 4): the per-level row matmuls are
far from the matmul floor, so the cost is materializing the one-hot operands
(oh_rows [2N, R] f32 + two [N, lanes] lane masks ~ 6 MB/iteration of
memory traffic).  Variants:

  base       ops/gn.fused_gn_iteration_onehot_stats as shipped
  oh_bf16    one-hot masks built in bf16 (half the bytes; values 0/1 exact)
  take_lane  lane select via take_along_axis on the FRESH [2N, lanes] sel
             (a small gather on a non-carried operand) instead of two
             [N, lanes] one-hot multiply-reduces
  both       oh_bf16 + take_lane

Full-pipeline hector replay (512 scans, onehot_bf16 + dense fill + early
exit — the headline config) with the variant monkeypatched in.

Usage: python scripts/bench_onehot_variants.py
"""
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from slamnet_tpu.runtime import setup_compile_cache
    setup_compile_cache()
    import numpy as np
    import jax.numpy as jnp

    from slamnet_tpu.core import HectorConfig, SimConfig
    from slamnet_tpu.core.scan import Scan
    from slamnet_tpu.models import hector
    from slamnet_tpu.ops import gn
    from slamnet_tpu.ops.gn import _gn_coords, _gn_tail
    from slamnet_tpu.sim import default_field, lidar
    from slamnet_tpu.sim.trajectory import loop_trajectory

    def make_variant(oh_dtype, take_lane):
        def fused(table2d, row_off, width, scale, pose_px, X, Y, valid,
                  deriv_clamp=0.2, xy_clamp=0.0, damping=0.0,
                  precision="bf16"):
            sr, cr, mx, my, ok, xi, yi = _gn_coords(width, scale, pose_px,
                                                    X, Y, valid)
            n = X.shape[0]
            total_rows = table2d.shape[0]
            lanes = table2d.shape[1]
            ry = row_off + yi
            rsel = jnp.concatenate([ry, ry + 1])
            oh_rows = (rsel[:, None] == jnp.arange(total_rows, dtype=ry.dtype)
                       ).astype(oh_dtype)
            prec = (jax.lax.Precision.HIGHEST if precision == "highest"
                    else None)
            sel = jnp.dot(oh_rows, table2d.astype(oh_dtype)
                          if oh_dtype != jnp.float32 else table2d,
                          precision=prec).astype(jnp.float32)
            r0, r1 = sel[:n], sel[n:]
            if take_lane:
                g0 = jnp.take_along_axis(r0, xi[:, None], axis=1)[:, 0]
                g1 = jnp.take_along_axis(r0, (xi + 1)[:, None], axis=1)[:, 0]
                g2 = jnp.take_along_axis(r1, xi[:, None], axis=1)[:, 0]
                g3 = jnp.take_along_axis(r1, (xi + 1)[:, None], axis=1)[:, 0]
                raw = jnp.stack([g0, g1, g2, g3])
            else:
                lane = jnp.arange(lanes, dtype=xi.dtype)
                oh0 = (xi[:, None] == lane).astype(oh_dtype)
                oh1 = ((xi + 1)[:, None] == lane).astype(oh_dtype)
                raw = jnp.stack([
                    (r0 * oh0).sum(axis=1), (r0 * oh1).sum(axis=1),
                    (r1 * oh0).sum(axis=1), (r1 * oh1).sum(axis=1)
                ]).astype(jnp.float32)
            v = jax.nn.sigmoid(raw)
            return _gn_tail(v, mx, my, xi, yi, ok, X, Y, sr, cr, pose_px,
                            deriv_clamp, True, xy_clamp, damping)
        return fused

    cfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4),
                       matcher_mode="onehot_bf16", dense_free_fill=True,
                       early_exit_tol=1e-3)
    sim = SimConfig()
    n_scans, bootstrap = 512, 10

    cpu = jax.devices("cpu")[0]
    fld = default_field()
    angles_np = lidar.revolution_angles(sim.num_scan_points)
    traj = loop_trajectory(speed=0.3)[: n_scans + bootstrap]
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

        radii_c, valids_c = genlog(jax.device_put(jnp.asarray(traj), cpu),
                                   jax.device_put(jax.random.PRNGKey(0), cpu))
    dev = jax.devices()[0]
    radii = jax.device_put(np.asarray(radii_c), dev)
    valids = jax.device_put(np.asarray(valids_c), dev)
    angles = jax.device_put(jnp.asarray(angles_np), dev)
    traj_d = jax.device_put(jnp.asarray(traj), dev)

    def make_cloud(r, v):
        pts = jnp.stack([r * jnp.cos(angles), r * jnp.sin(angles)], -1)
        return Scan(pts, v, jnp.zeros(3, jnp.float32))

    @jax.jit
    def boot(state, radii, valids, poses):
        def body(st, inp):
            r, v, p = inp
            st, _ = hector.update(st, make_cloud(r, v), p, cfg,
                                  map_without_matching=jnp.asarray(True))
            return st, None
        st, _ = jax.lax.scan(body, state, (radii, valids, poses))
        return st

    state = hector.init(cfg, traj[0])
    state = boot(state, radii[:bootstrap], valids[:bootstrap],
                 traj_d[:bootstrap])
    base_fn = gn.fused_gn_iteration_onehot_stats

    def measure(fn):
        gn.fused_gn_iteration_onehot_stats = fn

        @jax.jit
        def replay(state, radii, valids):
            def body(st, inp):
                r, v = inp
                st, _ = hector.update(st, make_cloud(r, v), st.match_pose,
                                      cfg, map_without_matching=jnp.asarray(False))
                return st, st.match_pose
            return jax.lax.scan(body, state, (radii, valids))

        stf, poses = replay(state, radii[bootstrap:], valids[bootstrap:])
        jax.block_until_ready(stf)
        best = float("inf")
        for _ in range(5):
            t0 = time.time()
            stf, poses = replay(state, radii[bootstrap:], valids[bootstrap:])
            jax.block_until_ready(stf)
            best = min(best, time.time() - t0)
        gn.fused_gn_iteration_onehot_stats = base_fn
        err = np.asarray(poses) - traj[bootstrap:]
        pe = np.linalg.norm(err[:, :2], axis=1)
        return n_scans / best, float(np.sqrt((pe ** 2).mean()))

    variants = {
        "base": base_fn,
        "oh_bf16": make_variant(jnp.bfloat16, False),
        "take_lane": make_variant(jnp.float32, True),
        "both": make_variant(jnp.bfloat16, True),
    }
    print(f"{'variant':>10} {'scans/s':>8} {'ate_m':>8}")
    for name, fn in variants.items():
        rate, ate = measure(fn)
        print(f"{name:>10} {rate:>8.1f} {ate:>8.4f}")


if __name__ == "__main__":
    main()
