#!/usr/bin/env python
"""In-process A/B: bare batched gather vs real _match_batch iteration cost.

PERF.md records 100x run-to-run variance across processes; this script
times, in ONE process, back to back:
  a) bare [4,B,N] flat gather in a scan (loop-variant table)
  b) fused_gn_iteration_batch in a scan (synthetic random table)
  c) _match_batch 1 level x 1 iter via replay (real empty maps)
  d) _match_batch 1 level x 7 iters
If (c)-(d) stay ~100x slower than (a)-(b) in-process, the difference is
program structure, not environment.
"""
import dataclasses
import sys
import time

sys.path.insert(0, ".")


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slamnet_tpu.core import HectorConfig
    from slamnet_tpu.models import fleet
    from slamnet_tpu.ops import gn

    B, N, C, iters, T = 64, 128, 210000, 64, 64
    width = 400
    rng = np.random.default_rng(0)
    tables = jnp.asarray(rng.normal(0, 1, (B, C)), jnp.float32)
    X = jnp.asarray(rng.uniform(-10, 10, (B, N)), jnp.float32)
    Y = jnp.asarray(rng.uniform(-10, 10, (B, N)), jnp.float32)
    V = jnp.ones((B, N), bool)
    poses = jnp.tile(jnp.asarray([200.0, 200.0, 0.1], jnp.float32), (B, 1))
    idx0 = (jnp.arange(B, dtype=jnp.int32)[:, None] * C
            + jnp.asarray(rng.integers(0, width * (width - 1) - 1, (B, N)),
                          jnp.int32))

    def timeit(name, fn, n_steps, *args):
        out = fn(*args)
        jax.block_until_ready(out)
        best = 1e9
        for _ in range(5):
            t0 = time.time()
            out = fn(*args)
            jax.block_until_ready(out)
            best = min(best, time.time() - t0)
        print(f"{name:44s} {best / n_steps * 1e6:9.1f} us/step")

    @jax.jit
    def bare(tables, idx0):
        def body(tb, _):
            flat = tb.reshape(-1)
            idx = jnp.stack([idx0, idx0 + 1, idx0 + width, idx0 + width + 1])
            v = jnp.take(flat, idx)
            tb = tb + v.sum() * 1e-30
            return tb, v.sum()
        return jax.lax.scan(body, tables, None, length=iters)

    @jax.jit
    def fused(tables, poses, X, Y, V):
        def body(carry, _):
            tb, p = carry
            p2, ok, rs, ni = gn.fused_gn_iteration_batch(
                tb.reshape(-1), C, 0, width, 10.0, p, X, Y, V)
            tb = tb + rs.sum() * 1e-30
            return (tb, p2), None
        return jax.lax.scan(body, (tables, poses), None, length=iters)

    cfg1 = HectorConfig(num_levels=1, estimate_iterations=(1,),
                        xy_step_clamp_px=10.0, match_subsample=4)
    cfg7 = dataclasses.replace(cfg1, estimate_iterations=(7,))
    radii = jnp.asarray(rng.uniform(2.0, 20.0, (T, B, 512)), jnp.float32)
    valids = jnp.ones((T, B, 512), bool)
    angles = jnp.asarray(np.linspace(0, 2 * np.pi, 512, endpoint=False),
                         jnp.float32)

    def make_match(cfg):
        states = fleet.init_fleet(cfg, np.tile(
            np.asarray([20.0, 20.0, 0.0], np.float32), (B, 1)))

        @jax.jit
        def match_only(states, radii, valids):
            def body(sts, inp):
                r, v = inp
                pts = jnp.stack([r * jnp.cos(angles)[None, :],
                                 r * jnp.sin(angles)[None, :]], -1)
                matched, _ = fleet._match_batch(sts.maps,
                                                fleet.fleet_cells(cfg),
                                                pts, v, sts.match_pose, cfg)
                sts = sts._replace(match_pose=matched)
                return sts, matched
            return jax.lax.scan(body, states, (radii, valids))
        return match_only, states

    print(f"device: {jax.devices()[0]}  B={B} N={N}")
    timeit("a) bare gather scan", bare, iters, tables, idx0)
    timeit("b) fused GN iter scan (synthetic)", fused, iters, tables, poses,
           X, Y, V)
    m1, s1 = make_match(cfg1)
    timeit("c) match replay 1L x 1it (per scan)", m1, T, s1, radii, valids)
    m7, s7 = make_match(cfg7)
    timeit("d) match replay 1L x 7it (per scan)", m7, T, s7, radii, valids)
    # re-time (a) afterwards to catch in-process drift
    timeit("a2) bare gather scan again", bare, iters, tables, idx0)


if __name__ == "__main__":
    main()
