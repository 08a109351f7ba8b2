#!/usr/bin/env python
"""Micro-bench: formulations of the 2x2 bilinear-neighborhood fetch.

The fused matcher's per-iteration cost is dominated by gathering 4 neighbors
for N beams from the map table.  Where gathers cost per INDEX, fewer
indices x bigger slices should win.  Candidates:

  flat4   — one stacked [4, N] scalar gather from the flat table (current)
  slice22 — lax.gather: N indices, slice_sizes=(2,2) from the [S,S] view
  rows2   — lax.gather: N indices, slice_sizes=(1,2), two calls (rows y, y+1)
  slice22_pairlane — same as slice22 but table pre-shaped [S, S/2, 2] so the
            minor dim is a lane pair (alignment probe)

Each timed as 15 sequential dependent iterations (like the GN loop) inside one
jit, replayed K times via lax.scan over dummy to amortize dispatch.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time
import numpy as np
import jax
import jax.numpy as jnp
from functools import partial

S = 400
N = 512
ITERS = 15
REPS = 200

key = jax.random.PRNGKey(0)
table2d = jax.random.normal(key, (S, S), jnp.float32)
table = table2d.reshape(-1)
xi0 = jax.random.randint(jax.random.PRNGKey(1), (N,), 0, S - 2, jnp.int32)
yi0 = jax.random.randint(jax.random.PRNGKey(2), (N,), 0, S - 2, jnp.int32)


def dep(v, xi, yi):
    """Make next iteration's indices depend on gathered values (serial chain)."""
    d = (v.sum() * 0.0).astype(jnp.int32)
    return xi + d, yi + d


def run_flat4(table, xi, yi):
    for _ in range(ITERS):
        base = yi * S + xi
        idx = jnp.stack([base, base + 1, base + S, base + S + 1])
        v = jnp.take(table, idx)          # [4, N]
        xi, yi = dep(v, xi, yi)
    return v.sum()


def run_slice22(table2d, xi, yi):
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2), collapsed_slice_dims=(),
        start_index_map=(0, 1))
    for _ in range(ITERS):
        idx = jnp.stack([yi, xi], axis=1)               # [N, 2]
        v = jax.lax.gather(table2d, idx, dn, slice_sizes=(2, 2),
                           mode=jax.lax.GatherScatterMode.CLIP)  # [N,2,2]
        xi, yi = dep(v, xi, yi)
    return v.sum()


def run_rows2(table2d, xi, yi):
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2), collapsed_slice_dims=(),
        start_index_map=(0, 1))
    for _ in range(ITERS):
        idx0 = jnp.stack([yi, xi], axis=1)
        idx1 = jnp.stack([yi + 1, xi], axis=1)
        v0 = jax.lax.gather(table2d, idx0, dn, slice_sizes=(1, 2),
                            mode=jax.lax.GatherScatterMode.CLIP)
        v1 = jax.lax.gather(table2d, idx1, dn, slice_sizes=(1, 2),
                            mode=jax.lax.GatherScatterMode.CLIP)
        v = jnp.concatenate([v0, v1], axis=1)
        xi, yi = dep(v, xi, yi)
    return v.sum()


def run_row_slice128(table2d, xi, yi):
    """Gather (2,128) slices — probe whether slice width is free."""
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2), collapsed_slice_dims=(),
        start_index_map=(0, 1))
    for _ in range(ITERS):
        idx = jnp.stack([yi, xi], axis=1)
        v = jax.lax.gather(table2d, idx, dn, slice_sizes=(2, 128),
                           mode=jax.lax.GatherScatterMode.CLIP)
        xi, yi = dep(v[:, :, :2], xi, yi)
    return v.sum()


def timed(name, fn, *args):
    @jax.jit
    def replay(*a):
        def body(c, _):
            return c + fn(*args) * 0.0, None
        out, _ = jax.lax.scan(body, jnp.float32(0), None, length=REPS)
        return out
    r = replay(*args)
    jax.block_until_ready(r)
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        jax.block_until_ready(replay(*args))
        best = min(best, time.time() - t0)
    per_iter = best / REPS / ITERS
    print(f"{name:18s}: {per_iter*1e6:8.2f} us/gather-iter "
          f"({best/REPS*1e6:8.1f} us per {ITERS}-iter chain)", flush=True)


timed("flat4", run_flat4, table, xi0, yi0)
timed("slice22", run_slice22, table2d, xi0, yi0)
timed("rows2", run_rows2, table2d, xi0, yi0)
timed("row_slice128", run_row_slice128, table2d, xi0, yi0)
