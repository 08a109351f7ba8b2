#!/usr/bin/env python
"""Test whether the fleet matcher's fixed per-GN-iteration cost is gather
operand prep on the loop-CARRIED table (PERF.md: loop-invariant tables
get their operand prep hoisted; loop-variant ones pay it per use).

In ONE process, times a T-scan matcher-only replay at B=64:
  a) maps in the scan carry (what replay_fleet does today)
  b) maps INVARIANT — passed to the scan body from outside (poses-only carry)
Same gathers, same iteration count; only the operand's loop-variance differs.
"""
import sys
import time

sys.path.insert(0, ".")


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slamnet_tpu.core import HectorConfig
    from slamnet_tpu.models import fleet

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
    cells = fleet.fleet_cells(cfg)

    def timeit(name, fn, *args):
        out = fn(*args)
        jax.block_until_ready(out)
        best = 1e9
        for _ in range(3):
            t0 = time.time()
            out = fn(*args)
            jax.block_until_ready(out)
            best = min(best, time.time() - t0)
        print(f"{name:44s} {best / T * 1e3:8.2f} ms/batch-scan")

    def pts_of(r):
        return jnp.stack([r * jnp.cos(angles)[None, :],
                          r * jnp.sin(angles)[None, :]], -1)

    @jax.jit
    def carry_maps(states, radii, valids):
        def body(sts, inp):
            r, v = inp
            matched, _ = fleet._match_batch(sts.maps, cells, pts_of(r), v,
                                            sts.match_pose, cfg)
            sts = sts._replace(match_pose=matched)
            return sts, matched
        return jax.lax.scan(body, states, (radii, valids))

    @jax.jit
    def invariant_maps(maps, pose0, radii, valids):
        def body(pose, inp):
            r, v = inp
            matched, _ = fleet._match_batch(maps, cells, pts_of(r), v, pose,
                                            cfg)
            return matched, matched
        return jax.lax.scan(body, pose0, (radii, valids))

    print(f"device: {jax.devices()[0]}  B={B} T={T}")
    timeit("a) maps in carry", carry_maps, states, radii, valids)
    timeit("b) maps invariant", invariant_maps, states.maps,
           states.match_pose, radii, valids)
    timeit("a2) maps in carry (re-run)", carry_maps, states, radii, valids)


if __name__ == "__main__":
    main()
