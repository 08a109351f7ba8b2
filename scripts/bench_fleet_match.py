#!/usr/bin/env python
"""Micro-bench: where does the batched matcher's per-GN-iteration time go?

Times, at B=64 N=128 on the GPU, per iteration:
  a) bare [4,B,N] flat-table gather, table loop-VARIANT (scan carry — what
     replay_fleet does)
  b) same gather, table loop-INVARIANT (closed over / xs)
  c) full fused_gn_iteration_batch, table loop-variant
  d) full fused_gn_iteration_batch, table loop-invariant

If (a) >> (b), the cost is gather operand prep / relayout paid per iteration
because the carry makes the operand loop-variant.
"""
import sys
import time

sys.path.insert(0, ".")


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slamnet_tpu.ops import gn

    B, N, C = 64, 128, 210000
    iters = 64
    rng = np.random.default_rng(0)
    tables = jnp.asarray(rng.normal(0, 1, (B, C)), jnp.float32)
    X = jnp.asarray(rng.uniform(-10, 10, (B, N)), jnp.float32)
    Y = jnp.asarray(rng.uniform(-10, 10, (B, N)), jnp.float32)
    V = jnp.ones((B, N), bool)
    poses = jnp.tile(jnp.asarray([200.0, 200.0, 0.1], jnp.float32), (B, 1))
    width = 400

    def timeit(name, fn, *args):
        out = fn(*args)
        jax.block_until_ready(out)
        best = 1e9
        for _ in range(5):
            t0 = time.time()
            out = fn(*args)
            jax.block_until_ready(out)
            best = min(best, time.time() - t0)
        print(f"{name:44s} {best / iters * 1e6:9.1f} us/iter")
        return out

    idx0 = (jnp.arange(B, dtype=jnp.int32)[:, None] * C
            + jnp.asarray(rng.integers(0, width * (width - 1) - 1, (B, N)),
                          jnp.int32))

    @jax.jit
    def gather_variant(tables, idx0):
        def body(tb, _):
            flat = tb.reshape(-1)
            idx = jnp.stack([idx0, idx0 + 1, idx0 + width, idx0 + width + 1])
            v = jnp.take(flat, idx)
            # touch the carry so the table stays loop-variant
            tb = tb + v.sum() * 1e-30
            return tb, v.sum()
        return jax.lax.scan(body, tables, None, length=iters)

    @jax.jit
    def gather_invariant(tables, idx0):
        flat = tables.reshape(-1)

        def body(acc, _):
            idx = jnp.stack([idx0, idx0 + 1, idx0 + width, idx0 + width + 1])
            v = jnp.take(flat, idx)
            return acc + v.sum(), None
        return jax.lax.scan(body, jnp.float32(0), None, length=iters)

    @jax.jit
    def full_variant(tables, poses, X, Y, V):
        def body(carry, _):
            tb, p = carry
            p2, ok, rs, ni = gn.fused_gn_iteration_batch(
                tb.reshape(-1), C, 0, width, 10.0, p, X, Y, V)
            tb = tb + rs.sum() * 1e-30
            return (tb, p2), None
        return jax.lax.scan(body, (tables, poses), None, length=iters)

    @jax.jit
    def full_invariant(tables, poses, X, Y, V):
        def body(p, _):
            p2, ok, rs, ni = gn.fused_gn_iteration_batch(
                tables.reshape(-1), C, 0, width, 10.0, p, X, Y, V)
            return p2, None
        return jax.lax.scan(body, poses, None, length=iters)

    print(f"device: {jax.devices()[0]}  B={B} N={N} C={C} "
          f"table={B * C * 4 / 1e6:.0f} MB")
    timeit("bare gather, table loop-variant", gather_variant, tables, idx0)
    timeit("bare gather, table loop-invariant", gather_invariant, tables, idx0)
    timeit("fused GN iter, table loop-variant", full_variant, tables, poses,
           X, Y, V)
    timeit("fused GN iter, table loop-invariant", full_invariant, tables,
           poses, X, Y, V)


if __name__ == "__main__":
    main()
