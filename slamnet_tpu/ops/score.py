"""Monte-Carlo candidate scoring against the hole map — CoreSLAM's hot loop #1.

Array reframing of MonteCarloSearch + CalculateDistanceSISD
(CoreSLAMProcessor.cs:624-653, 226-259): the reference perturbs the SAME search pose
`iterations` times per thread and keeps the argmin, so N threads x M iterations is
*distributionally identical* to one batch of N*M independent candidates scored at
once.  Here the whole batch is scored in one fused computation: a [B,2,2] x [N,2]
batched rotate-translate, integer pixel snap with C# truncation semantics, a gather
from the hole map, and a masked sum — then a single argmin replaces the reference's
two-level (per-thread then host) reduction (CoreSLAMProcessor.cs:695-709).

Score ordering note: the reference score is ``sum * 1024 / cloud.Count`` with the
SAME denominator for every candidate, so the argmin over candidates is exactly the
argmin over in-bounds pixel sums (int32-exact here; no float rounding can flip the
order).  Out-of-bounds points are skipped (sum unchanged) exactly as in the
reference, and a candidate with zero in-bounds points scores int-max
(CoreSLAMProcessor.cs:251-258).
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


def score_candidates(hole_map_flat: jnp.ndarray, size: int, scale: float,
                     points: jnp.ndarray, valid: jnp.ndarray,
                     poses: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Score B candidate poses; returns (sum i32[B], nb_points i32[B]).

    hole_map_flat: i32[size*size]; points: f32[N,2]; valid: bool[N];
    poses: f32[B,3].  Pixel snap reproduces CalculateDistanceSISD: the +0.5
    center-bias then C# (int) truncation (CoreSLAMProcessor.cs:232-241).
    """
    px = poses[:, 0] * scale + 0.5
    py = poses[:, 1] * scale + 0.5
    c = jnp.cos(poses[:, 2]) * scale
    s = jnp.sin(poses[:, 2]) * scale

    X = points[:, 0][None, :]          # [1, N]
    Y = points[:, 1][None, :]
    x = csharp_trunc(px[:, None] + c[:, None] * X - s[:, None] * Y)   # [B, N]
    y = csharp_trunc(py[:, None] + s[:, None] * X + c[:, None] * Y)

    in_b = (x >= 0) & (x < size) & (y >= 0) & (y < size) & valid[None, :]
    flat = jnp.clip(y * size + x, 0, size * size - 1)
    vals = jnp.take(hole_map_flat, flat, axis=0)                      # [B, N]
    vals = jnp.where(in_b, vals, 0)
    return vals.sum(axis=1, dtype=jnp.int32), in_b.sum(axis=1, dtype=jnp.int32)


def reference_score(sums: jnp.ndarray, nb: jnp.ndarray, total_points) -> jnp.ndarray:
    """The reference's score value ``sum*1024/count`` (for metrics/parity checks);
    int-max when nothing in bounds."""
    total = jnp.maximum(jnp.asarray(total_points, jnp.int64), 1)
    score = (sums.astype(jnp.int64) * 1024) // total
    return jnp.where(nb > 0, score, jnp.int64(2**31 - 1))


def monte_carlo_search(hole_map_flat: jnp.ndarray, size: int, scale: float,
                       points: jnp.ndarray, valid: jnp.ndarray,
                       search_pose: jnp.ndarray, sigma_xy: float,
                       sigma_theta: float, num_candidates: int,
                       key) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sample candidates ~ N(search_pose, diag(sxy, sxy, stheta)) and return
    (best_pose f32[3], best_sum i32).

    Candidate 0 is the unperturbed search pose (the reference scores it first as the
    initial best, CoreSLAMProcessor.cs:626-628).  Argmin keeps the first minimum,
    mirroring the reference's strict-improvement update order.
    """
    kxy, kth = jax.random.split(key)
    dxy = jax.random.normal(kxy, (num_candidates, 2)) * sigma_xy
    dth = jax.random.normal(kth, (num_candidates, 1)) * sigma_theta
    deltas = jnp.concatenate([dxy, dth], axis=1)
    deltas = deltas.at[0].set(0.0)
    cands = search_pose[None, :] + deltas

    sums, nb = score_candidates(hole_map_flat, size, scale, points, valid, cands)
    eff = jnp.where(nb > 0, sums, INT32_MAX)
    best = jnp.argmin(eff)
    return cands[best], eff[best]
