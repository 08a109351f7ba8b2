"""Correlative candidate search — the deterministic production CoreSLAM matcher.

The reference's Monte-Carlo search (CoreSLAMProcessor.cs:624-653) samples
continuous (x, y, theta) perturbations, but CalculateDistance snaps candidates to
integer hole-map pixels (:232-241) — every candidate inside the same pixel scores
identically, so continuous XY sampling spends most of its budget re-scoring
duplicates.  This module scores the ENTIRE reachable pixel neighborhood instead:

    score(theta_k, dy, dx) = sum_p H[yb_kp + dy, xb_kp + dx]

for K theta bins x a WxW window of integer pixel shifts — dense deterministic
coverage of the same search region (a 2D-lidar analogue of Olson's correlative
scan matching, reframed as a matrix product):

  1. per theta bin, snap the rotated cloud once and scatter point COUNTS into a
     zero-padded count grid (K*N updates — the only scatter, ~1% of the budget);
  2. materialize the W*W shifted copies of the (zero-padded) hole map;
  3. scores = counts @ shifted_maps^T — one matmul.  The map is split into
     hi/lo 8-bit planes so the f32 matmul is integer-EXACT (sums reach 26-bit).

Zero padding reproduces the reference's out-of-bounds semantics exactly: an OOB
point contributes 0 to the sum and 0 to the in-bounds count (the reference skips
it, CoreSLAMProcessor.cs:251-254); all-OOB candidates score int-max (:256-258).

After the integer argmin, a clamped 1D quadratic fit along each axis recovers the
sub-pixel/sub-bin optimum — the MC mode's continuous samples resolve this
stochastically; the fit does it deterministically.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.geometry import csharp_trunc

# numpy scalar, NOT jnp: a module-level device array would initialize
# the XLA backend at import time, breaking jax.distributed.initialize
# in multi-process runs (tests/_multiproc_worker.py)
INT32_MAX = np.int32(2**31 - 1)


def correlative_scores(hole_map_flat: jnp.ndarray, size: int, scale: float,
                       points: jnp.ndarray, valid: jnp.ndarray,
                       search_pose: jnp.ndarray, thetas: jnp.ndarray,
                       window: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Raw score grid: (sums i32[K, W, W], nb i32[K, W, W]).

    Shift (dy, dx) indexes pixel offsets dy - W//2, dx - W//2 relative to the
    snapped base coordinates at `search_pose` xy; `thetas` f32[K] are absolute
    headings.  Exact vs score_candidates for interior points (the pixel snap of
    a shifted candidate equals base snap + shift except across the truncation
    discontinuity at negative coords — outside the map anyway).
    """
    K = thetas.shape[0]
    N = points.shape[0]
    R = window // 2
    spad = size + 2 * R

    px = search_pose[0] * scale + 0.5
    py = search_pose[1] * scale + 0.5
    c = (jnp.cos(thetas) * scale)[:, None]
    s = (jnp.sin(thetas) * scale)[:, None]
    X = points[:, 0][None, :]
    Y = points[:, 1][None, :]
    xb = csharp_trunc(px + c * X - s * Y)          # [K, N]
    yb = csharp_trunc(py + s * X + c * Y)

    # count grids over the padded index range [-R, size + R): built as one-hot
    # OUTER PRODUCTS — cnt[k, y, x] = sum_p 1[yb_kp == y][xb_kp == x] —
    # instead of a K*N-update scatter-add.  Exact: each point contributes a
    # single 1.0; sums stay < 2^24.
    ok = (valid[None, :] & (xb >= -R) & (xb < size + R)
          & (yb >= -R) & (yb < size + R))
    grid_ids = jnp.arange(spad, dtype=xb.dtype)
    oh_y = ((yb + R)[:, :, None] == grid_ids).astype(jnp.float32) \
        * ok[:, :, None].astype(jnp.float32)                    # [K, N, spad]
    oh_x = ((xb + R)[:, :, None] == grid_ids).astype(jnp.float32)
    cnt = jnp.einsum("kns,knt->kst", oh_y, oh_x,
                     preferred_element_type=jnp.float32).reshape(
        K, spad * spad)

    # in-bounds candidate counts WITHOUT map-plane traffic (round 5, +72%
    # pipeline throughput): a shifted candidate's in-bounds test is a box
    # condition SEPARABLE per point — (0 <= yb+dy' < size) AND
    # (0 <= xb+dx' < size) — so nb is one einsum over tiny [K, N, W]
    # row/column masks instead of W*W materialized mask planes (which were a
    # third of the ~54 MB/scan shifted-plane operand).  Exact: each point
    # contributes exactly 1.0; sums < 2^24.
    dshift = jnp.arange(window, dtype=xb.dtype) - R
    rowok = (ok[:, :, None] & ((yb[:, :, None] + dshift) >= 0)
             & ((yb[:, :, None] + dshift) < size)).astype(jnp.float32)
    colok = (((xb[:, :, None] + dshift) >= 0)
             & ((xb[:, :, None] + dshift) < size)).astype(jnp.float32)
    nb = jnp.einsum("knw,knv->kwv", rowok, colok,
                    preferred_element_type=jnp.float32).astype(jnp.int32)

    # shifted hole-map copies from the doubly-padded plane (zeros outside)
    q = jnp.zeros((size + 4 * R, size + 4 * R), jnp.int32)
    q = jax.lax.dynamic_update_slice(q, hole_map_flat.reshape(size, size),
                                     (2 * R, 2 * R))
    shifts = []
    for dy in range(window):
        for dx in range(window):
            shifts.append(jax.lax.dynamic_slice(
                q, (dy, dx), (spad, spad)).reshape(-1))
    hs = jnp.stack(shifts)                          # i32 [W*W, spad*spad]

    # integer-exact f32 matmul via 8-bit planes (hi*256 + lo; partial sums
    # stay < 2^17 * N, well inside the f32 24-bit integer range; a TF32
    # matmul keeps 8-bit-plane integers and per-cell point counts < 2048
    # exact — chip_smoke.py checks the scores integer-exact on the card).
    # Both planes stacked into ONE [2*W*W, ...] operand: one pass over the
    # big loop-variant operand.  (A lax.conv cross-correlation formulation
    # was measured slower — scripts/bench_correlate_variants.py.)
    w2 = window * window
    big = jnp.concatenate([(hs >> 8).astype(jnp.float32),
                           (hs & 0xFF).astype(jnp.float32)], axis=0)
    out = jnp.dot(cnt, big.T, preferred_element_type=jnp.float32)  # [K, 2*W*W]
    sums = (256.0 * out[:, :w2] + out[:, w2:2 * w2]).astype(jnp.int32)
    return (sums.reshape(K, window, window), nb.reshape(K, window, window))


def _quad_offset(fm, f0, fp):
    """Sub-sample offset of the parabola through (-1, fm), (0, f0), (+1, fp);
    0 when the fit is degenerate or non-convex, clamped to +/-0.5."""
    d = fm - 2.0 * f0 + fp
    off = jnp.where(d > 1e-6, 0.5 * (fm - fp) / jnp.where(d == 0, 1.0, d), 0.0)
    return jnp.clip(off, -0.5, 0.5)


def correlative_search(hole_map_flat: jnp.ndarray, size: int, scale: float,
                       points: jnp.ndarray, valid: jnp.ndarray,
                       search_pose: jnp.ndarray, window: int, num_theta: int,
                       theta_span: float,
                       subpixel: bool = True) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Best (pose f32[3], sum i32) over the (theta, dy, dx) grid around
    `search_pose` — drop-in for ops/score.monte_carlo_search (same contract:
    lower sum is better, all-OOB candidates score int-max, first minimum wins).
    """
    thetas = search_pose[2] + jnp.linspace(-theta_span, theta_span, num_theta)
    sums, nb = correlative_scores(hole_map_flat, size, scale, points, valid,
                                  search_pose, thetas, window)
    eff = jnp.where(nb > 0, sums, INT32_MAX)
    return refine_from_scores(eff, search_pose, scale, window, num_theta,
                              theta_span, subpixel)


def refine_from_scores(eff: jnp.ndarray, search_pose, scale: float,
                       window: int, num_theta: int, theta_span: float,
                       subpixel: bool = True) -> Tuple[jnp.ndarray,
                                                       jnp.ndarray]:
    """Argmin + sub-pixel/sub-bin quadratic refinement over an effective score
    grid eff i32[K, W, W] (int-max = invalid).  Split out so the sharded
    pipeline (models/coreslam_sharded) can all-gather its per-shard theta
    slices and run the IDENTICAL refinement — bit-exact winner selection."""
    R = window // 2
    flat_idx = jnp.argmin(eff.reshape(-1))
    k = flat_idx // (window * window)
    rem = flat_idx % (window * window)
    iy = rem // window
    ix = rem % window

    fy = iy.astype(jnp.float32)
    fx = ix.astype(jnp.float32)
    fk = k.astype(jnp.float32)
    if subpixel:
        e = eff.astype(jnp.float32)
        K = num_theta

        def at(kk, yy, xx):
            return e[jnp.clip(kk, 0, K - 1), jnp.clip(yy, 0, window - 1),
                     jnp.clip(xx, 0, window - 1)]

        f0 = at(k, iy, ix)
        fx = fx + _quad_offset(at(k, iy, ix - 1), f0, at(k, iy, ix + 1))
        fy = fy + _quad_offset(at(k, iy - 1, ix), f0, at(k, iy + 1, ix))
        fk = fk + _quad_offset(at(k - 1, iy, ix), f0, at(k + 1, iy, ix))

    dtheta = 2.0 * theta_span / max(num_theta - 1, 1)
    pose = jnp.stack([search_pose[0] + (fx - R) / scale,
                      search_pose[1] + (fy - R) / scale,
                      search_pose[2] - theta_span + fk * dtheta])
    return pose, eff.reshape(-1)[flat_idx]
