#!/usr/bin/env python
"""Isolate the fleet batch-scan overhead: the GN math is a small part of
it (scripts/bench_fleet_match.py), the rest is machinery around it.

Times T-scan replays at B=64 with progressively more machinery:
  a) matcher only (maps in carry, no gate/update phase at all)
  b) + gate computation (argsort/chosen), still no update scan
  c) + update scan with cap slots, gates forced shut
  d) full update_fleet, gates forced shut (should equal c)
"""
import sys
import time

sys.path.insert(0, ".")


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slamnet_tpu.core import HectorConfig
    from slamnet_tpu.core.scan import Scan
    from slamnet_tpu.models import fleet, hector

    cfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4),
                       xy_step_clamp_px=10.0, match_subsample=4)
    B, T, N = 64, 64, 512
    rng = np.random.default_rng(0)
    poses0 = np.tile(np.asarray([20.0, 20.0, 0.0], np.float32), (B, 1))
    states = fleet.init_fleet(cfg, poses0)
    radii = jnp.asarray(rng.uniform(2.0, 20.0, (T, B, N)), jnp.float32)
    valids = jnp.ones((T, B, N), bool)
    angles = jnp.asarray(np.linspace(0, 2 * np.pi, N, endpoint=False),
                         jnp.float32)

    def timeit(name, fn, *args):
        out = fn(*args)
        jax.block_until_ready(out)
        best = 1e9
        for _ in range(3):
            t0 = time.time()
            out = fn(*args)
            jax.block_until_ready(out)
            best = min(best, time.time() - t0)
        print(f"{name:40s} {best / T * 1e3:8.2f} ms/batch-scan")

    def pts_of(r):
        return jnp.stack([r * jnp.cos(angles)[None, :],
                          r * jnp.sin(angles)[None, :]], -1)

    @jax.jit
    def match_only(states, radii, valids):
        def body(sts, inp):
            r, v = inp
            matched, _ = fleet._match_batch(sts.maps, fleet.fleet_cells(cfg),
                                            pts_of(r), v, sts.match_pose,
                                            cfg)
            sts = sts._replace(match_pose=matched)
            return sts, matched
        return jax.lax.scan(body, states, (radii, valids))

    @jax.jit
    def match_gate(states, radii, valids):
        def body(sts, inp):
            r, v = inp
            matched, _ = fleet._match_batch(sts.maps, fleet.fleet_cells(cfg),
                                            pts_of(r), v, sts.match_pose,
                                            cfg)
            dist2 = jnp.sum((matched[:, :2]
                             - sts.last_update_pose[:, :2]) ** 2, axis=1)
            do_update = dist2 > 1e18
            order = jnp.argsort(~do_update, stable=True)
            chosen = order[:8].astype(jnp.int32)
            sts = hector.HectorState(sts.maps, matched,
                                     jnp.where(do_update[:, None], matched,
                                               sts.last_update_pose))
            return sts, chosen
        return jax.lax.scan(body, states, (radii, valids))

    @jax.jit
    def match_gate_scan(states, radii, valids):
        def body(sts, inp):
            r, v = inp
            pts = pts_of(r)
            matched, _ = fleet._match_batch(sts.maps, fleet.fleet_cells(cfg),
                                            pts, v, sts.match_pose, cfg)
            do_update = jnp.zeros(matched.shape[0], bool)
            order = jnp.argsort(~do_update, stable=True)
            chosen = order[:8].astype(jnp.int32)

            cells = fleet.fleet_cells(cfg)

            def slot(maps_flat, inp2):
                i, gate, pose, p, vv = inp2
                m = jax.lax.dynamic_slice_in_dim(maps_flat, i * cells, cells,
                                                 axis=0)

                def do(m):
                    cloud = Scan(p, vv, jnp.zeros(3, jnp.float32))
                    return hector.update_maps(m, cloud, pose, cfg)

                m2 = jax.lax.cond(gate, do, lambda m: m, m)
                return jax.lax.dynamic_update_slice_in_dim(
                    maps_flat, m2, i * cells, axis=0), None

            new_maps, _ = jax.lax.scan(
                slot, sts.maps,
                (chosen, do_update[chosen], matched[chosen], pts[chosen],
                 v[chosen]))
            sts = hector.HectorState(new_maps, matched, sts.last_update_pose)
            return sts, None
        return jax.lax.scan(body, states, (radii, valids))

    import dataclasses
    shut = dataclasses.replace(cfg, min_distance_diff_for_map_update=1e9,
                               min_angle_diff_for_map_update=1e9)

    @jax.jit
    def full_shut(states, radii, valids):
        return fleet.replay_fleet(states, radii, valids, angles, shut)

    print(f"device: {jax.devices()[0]}  B={B} T={T}")
    timeit("a) matcher only", match_only, states, radii, valids)
    timeit("b) + gates/argsort", match_gate, states, radii, valids)
    timeit("c) + update scan (gates shut)", match_gate_scan, states, radii,
           valids)
    timeit("d) full update_fleet (gates shut)", full_shut, states, radii,
           valids)


if __name__ == "__main__":
    main()
