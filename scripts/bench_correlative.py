#!/usr/bin/env python
"""Micro-bench: correlative CoreSLAM search formulations vs the MC baseline.

Score(theta_k, dy, dx) = sum_p H[yb_kp + dy, xb_kp + dx] for all K theta bins and
a WxW window of integer pixel shifts.  Candidates:

  mc4096     — current monte_carlo_search (baseline)
  gatherWW   — ONE lax.gather: K*N indices, slice_sizes=(W,W) from zero-padded
               map, then [K,N,W,W] -> sum over N
  scatmm     — per-theta point-count grids via ONE scatter-add (K*N updates),
               then [K, S*S] @ [S*S, W*W] shifted-map matmul
  gather_rows— ONE gather of (1,W) row slices for each of W dy shifts folded
               into indices: K*N*W indices, slice (1,W)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time
import numpy as np
import jax
import jax.numpy as jnp

from slamnet_tpu.ops import score as score_ops

S = 256
N = 512
K = 32          # theta bins
W = 8           # shift window (pixels)
R = W // 2
REPS = 50

key = jax.random.PRNGKey(0)
hole = jax.random.randint(key, (S * S,), 0, 65500, jnp.int32)
pts = jax.random.uniform(jax.random.PRNGKey(1), (N, 2), jnp.float32, -18, 18)
valid = jnp.ones(N, bool)
pose = jnp.array([20.0, 20.0, 0.2], jnp.float32)
scale = 256 / 40.0


def timed(name, fn, *args):
    @jax.jit
    def replay(*a):
        def body(c, _):
            out = fn(*a)
            return c + out.astype(jnp.float32) * 0.0, None
        out, _ = jax.lax.scan(body, jnp.float32(0), None, length=REPS)
        return out
    r = replay(*args)
    jax.block_until_ready(r)
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        jax.block_until_ready(replay(*args))
        best = min(best, time.time() - t0)
    print(f"{name:12s}: {best/REPS*1e6:9.1f} us/scan -> {1.0/(best/REPS):7.0f} scans/s",
          flush=True)


def mc(hole, pts, valid, pose):
    best, s = score_ops.monte_carlo_search(hole, S, scale, pts, valid, pose,
                                           0.1, np.pi / 18, 4096,
                                           jax.random.PRNGKey(7))
    return s


def base_coords(pose):
    thetas = pose[2] + jnp.linspace(-np.pi / 6, np.pi / 6, K)
    c = jnp.cos(thetas)[:, None] * scale
    s = jnp.sin(thetas)[:, None] * scale
    X, Y = pts[:, 0][None, :], pts[:, 1][None, :]
    px = pose[0] * scale + 0.5
    py = pose[1] * scale + 0.5
    xb = jnp.floor(px + c * X - s * Y).astype(jnp.int32)   # [K, N]
    yb = jnp.floor(py + s * X + c * Y).astype(jnp.int32)
    return xb, yb


def gatherWW(hole, pts, valid, pose):
    xb, yb = base_coords(pose)
    pad = jnp.zeros((S + 2 * R, S + 2 * R), jnp.int32)
    pad = jax.lax.dynamic_update_slice(pad, hole.reshape(S, S), (R, R))
    # window top-left for shift range [-R, R): (yb - R) + R pad offset = yb
    idx = jnp.stack([yb, xb], axis=-1).reshape(-1, 2)      # [K*N, 2]
    idx = jnp.clip(idx, 0, S + 2 * R - W)
    dn = jax.lax.GatherDimensionNumbers(offset_dims=(1, 2),
                                        collapsed_slice_dims=(),
                                        start_index_map=(0, 1))
    g = jax.lax.gather(pad, idx, dn, slice_sizes=(W, W),
                       mode=jax.lax.GatherScatterMode.CLIP)  # [K*N, W, W]
    sc = g.reshape(K, N, W, W).sum(axis=1)
    return jnp.argmin(sc.reshape(-1))


def scatmm(hole, pts, valid, pose):
    xb, yb = base_coords(pose)
    ok = (xb >= 0) & (xb < S) & (yb >= 0) & (yb < S)
    flat = jnp.where(ok, yb * S + xb, 0)
    kidx = jnp.broadcast_to(jnp.arange(K)[:, None], (K, N))
    lin = (kidx * (S * S) + flat).reshape(-1)
    cnt = jnp.zeros((K * S * S,), jnp.float32).at[lin].add(
        ok.reshape(-1).astype(jnp.float32))
    cnt = cnt.reshape(K, S * S)
    # shifted maps [W*W, S*S]
    pad = jnp.zeros((S + 2 * R, S + 2 * R), jnp.float32)
    pad = jax.lax.dynamic_update_slice(pad, hole.reshape(S, S).astype(jnp.float32),
                                       (R, R))
    shifts = []
    for dy in range(W):
        for dx in range(W):
            shifts.append(jax.lax.dynamic_slice(pad, (dy, dx), (S, S)).reshape(-1))
    Hs = jnp.stack(shifts)                                  # [W*W, S*S]
    sc = jnp.dot(cnt, Hs.T, preferred_element_type=jnp.float32)  # [K, W*W]
    return jnp.argmin(sc.reshape(-1))


def gather_rows(hole, pts, valid, pose):
    xb, yb = base_coords(pose)
    pad = jnp.zeros((S + 2 * R, S + 2 * R), jnp.int32)
    pad = jax.lax.dynamic_update_slice(pad, hole.reshape(S, S), (R, R))
    dys = jnp.arange(W)
    yy = (yb[:, :, None] + dys[None, None, :]).reshape(-1)   # [K*N*W]
    xx = jnp.broadcast_to(xb[:, :, None], (K, N, W)).reshape(-1)
    idx = jnp.stack([yy, xx], axis=-1)
    idx = jnp.clip(idx, 0, S + 2 * R - W)
    dn = jax.lax.GatherDimensionNumbers(offset_dims=(1, 2),
                                        collapsed_slice_dims=(),
                                        start_index_map=(0, 1))
    g = jax.lax.gather(pad, idx, dn, slice_sizes=(1, W),
                       mode=jax.lax.GatherScatterMode.CLIP)
    sc = g.reshape(K, N, W, W).sum(axis=1)
    return jnp.argmin(sc.reshape(-1))


timed("mc4096", mc, hole, pts, valid, pose)
timed("gatherWW", gatherWW, hole, pts, valid, pose)
timed("scatmm", scatmm, hole, pts, valid, pose)
timed("gather_rows", gather_rows, hole, pts, valid, pose)
