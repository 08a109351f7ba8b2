#!/usr/bin/env python
"""Isolate per-GN-iteration cost and the gated-update overhead.

Part 1: one fused_gn_iteration chain (15 iters) in replay — current vs variants:
  cur    — ops/gn.fused_gn_iteration as-is (two jnp.dot)
  red9   — replace the two dots with ONE [9,N] stack + sum reduction
  lean   — red9 + inline scalar solve (no stack/cross), fewer tiny ops

Part 2: lax.cond(update_maps) replay with predicate always False vs always True
vs no cond at all — where does the per-scan time go?
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time
import numpy as np
import jax
import jax.numpy as jnp

from slamnet_tpu.core import HectorConfig
from slamnet_tpu.core.scan import Scan
from slamnet_tpu.models import hector
from slamnet_tpu.ops import gn

cfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4))
S = cfg.map_size
N = 512
REPS = 200
ITERS = 15

key = jax.random.PRNGKey(0)
table = jax.random.normal(key, (cfg.total_cells,), jnp.float32)
X = jax.random.uniform(jax.random.PRNGKey(1), (N,), jnp.float32, -20, 20)
Y = jax.random.uniform(jax.random.PRNGKey(2), (N,), jnp.float32, -20, 20)
valid = jnp.ones(N, bool)
pose0 = jnp.array([200.0, 200.0, 0.1], jnp.float32)
scale = 1.0 / cfg.level_resolutions[0]


def solve_lean(H00, H01, H02, H11, H12, H22, d0, d1, d2, clamp):
    """Scalar symmetric 3x3 adjugate solve, minimal op count."""
    a0 = H11 * H22 - H12 * H12
    a1 = H02 * H12 - H01 * H22
    a2 = H01 * H12 - H02 * H11
    det = H00 * a0 + H01 * a1 + H02 * a2
    b1 = H00 * H22 - H02 * H02
    b2 = H01 * H02 - H00 * H12
    c2 = H00 * H11 - H01 * H01
    ok = (H00 != 0.0) & (H11 != 0.0) & (det != 0.0) & jnp.isfinite(det)
    inv = jnp.where(ok, 1.0 / jnp.where(det == 0.0, 1.0, det), 0.0)
    s0 = (a0 * d0 + a1 * d1 + a2 * d2) * inv
    s1 = (a1 * d0 + b1 * d1 + b2 * d2) * inv
    s2 = (a2 * d0 + b2 * d1 + c2 * d2) * inv
    s2 = jnp.clip(s2, -clamp, clamp)
    return jnp.stack([s0, s1, s2])


def iter_red9(table, offset, width, scale, pose_px, X, Y, valid, clamp=0.2):
    sr = jnp.sin(pose_px[2]) * scale
    cr = jnp.cos(pose_px[2]) * scale
    mx = cr * X - sr * Y + pose_px[0]
    my = sr * X + cr * Y + pose_px[1]
    ok = valid & (mx >= 0.0) & (mx <= width - 2) & (my >= 0.0) & (my <= width - 2)
    xi = jnp.clip(mx.astype(jnp.int32), 0, width - 2)
    yi = jnp.clip(my.astype(jnp.int32), 0, width - 2)
    base = offset + yi * width + xi
    idx = jnp.stack([base, base + 1, base + width, base + width + 1])
    v = jax.nn.sigmoid(jnp.take(table, idx))
    fx = mx - xi
    fy = my - yi
    xf = 1.0 - fx
    yf = 1.0 - fy
    val = (v[0] * xf + v[1] * fx) * yf + (v[2] * xf + v[3] * fx) * fy
    gx = -((v[0] - v[1]) * xf + (v[2] - v[3]) * fx)
    gy = -((v[0] - v[2]) * yf + (v[1] - v[3]) * fy)
    z = jnp.float32(0.0)
    gx = jnp.where(ok, gx, z)
    gy = jnp.where(ok, gy, z)
    fun = jnp.where(ok, 1.0 - val, z)
    rot = (-sr * X - cr * Y) * gx + (cr * X - sr * Y) * gy
    red = jnp.stack([gx * fun, gy * fun, rot * fun,
                     gx * gx, gx * gy, gx * rot,
                     gy * gy, gy * rot, rot * rot]).sum(axis=1)
    d0, d1, d2, H00, H01, H02, H11, H12, H22 = red
    return pose_px + solve_lean(H00, H01, H02, H11, H12, H22, d0, d1, d2, clamp)


def chain(fn):
    def run(table, pose):
        for _ in range(ITERS):
            pose = fn(table, 0, S, scale, pose, X, Y, valid)
        return pose
    return run


def timed(name, fn, *args):
    @jax.jit
    def replay(*a):
        def body(c, _):
            return fn(*a[:-1], c), None
        out, _ = jax.lax.scan(body, a[-1], None, length=REPS)
        return out
    r = replay(*args)
    jax.block_until_ready(r)
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        jax.block_until_ready(replay(*args))
        best = min(best, time.time() - t0)
    print(f"{name:24s}: {best/REPS*1e6:8.1f} us per {ITERS}-iter chain "
          f"({best/REPS/ITERS*1e6:6.2f} us/iter)", flush=True)


timed("cur (two dots)", chain(gn.fused_gn_iteration), table, pose0)
timed("red9 + lean solve", chain(iter_red9), table, pose0)

# ---- Part 2: gated update cost --------------------------------------------
angles = jnp.linspace(0, 2 * np.pi, N, endpoint=False)
radii = jax.random.uniform(jax.random.PRNGKey(3), (REPS, N), jnp.float32, 2, 18)
pose_w = jnp.array([20.0, 20.0, 0.3], jnp.float32)


def make_cloud(r):
    pts = jnp.stack([r * jnp.cos(angles), r * jnp.sin(angles)], -1)
    return Scan(pts, jnp.ones(N, bool), jnp.zeros(3, jnp.float32))


def upd_replay(pred_val):
    @jax.jit
    def replay(maps, radii):
        def body(m, r):
            def w(mm):
                return hector.update_maps(mm, make_cloud(r), pose_w, cfg)
            m2 = jax.lax.cond(jnp.asarray(pred_val), w, lambda mm: mm, m)
            return m2, None
        out, _ = jax.lax.scan(body, maps, radii)
        return out
    return replay


maps0 = jnp.zeros((cfg.total_cells,), jnp.float32)
for name, pv in [("cond FALSE every scan", False), ("cond TRUE every scan", True)]:
    replay = upd_replay(pv)
    r = replay(maps0, radii)
    jax.block_until_ready(r)
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        jax.block_until_ready(replay(maps0, radii))
        best = min(best, time.time() - t0)
    print(f"{name:24s}: {best/REPS*1e6:8.1f} us/scan", flush=True)

# no cond, no update: pure carry pass-through baseline
@jax.jit
def replay_id(maps, radii):
    def body(m, r):
        return m, jnp.sum(r) * 0.0
    out, _ = jax.lax.scan(body, maps, radii)
    return out

r = replay_id(maps0, radii)
jax.block_until_ready(r)
best = float("inf")
for _ in range(3):
    t0 = time.time()
    jax.block_until_ready(replay_id(maps0, radii))
    best = min(best, time.time() - t0)
print(f"{'no cond baseline':24s}: {best/REPS*1e6:8.1f} us/scan", flush=True)
