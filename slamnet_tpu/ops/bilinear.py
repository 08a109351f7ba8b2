"""Bilinear probability interpolation + gradients — Hector's hot loop #3.

Reference: ScanMatcher.InterpMapValueWithDerivatives (ScanMatcher.cs:211-249) with
OccGridMap.GetCachedProbability (OccGridMap.cs:97-107).  The reference's lazy
per-cell probability cache is unnecessary here: we gather the 4 log-odds cells and
apply sigmoid inline (4 exps per point beat materializing a second map).

GRADIENT QUIRK (reproduced intentionally): the reference — inheriting from upstream
hector_slam — interpolates the x-difference pair (dx1, dx2) with the *x* factors and
the y-pair with the *y* factors (ScanMatcher.cs:247-248), where textbook bilinear
gradients would use the opposite factor axis.  This works in practice and matching
it keeps Gauss-Newton iterates comparable with the reference.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def interp_value_and_gradients(logodds_flat: jnp.ndarray, width: int,
                               coords: jnp.ndarray,
                               valid: jnp.ndarray) -> Tuple[jnp.ndarray,
                                                            jnp.ndarray,
                                                            jnp.ndarray]:
    """Probability value + (gx, gy) at continuous map coords for N points.

    logodds_flat: f32[width*height]; coords: f32[N, 2] map pixels; valid: bool[N].
    Out-of-bounds points (coords outside [0, dim-2], the reference's Limits margin,
    MapProperties.cs:42,83-87) return (0, 0, 0) exactly as ScanMatcher.cs:216-219.
    """
    x, y = coords[:, 0], coords[:, 1]
    in_b = (valid & (x >= 0.0) & (x <= width - 2) & (y >= 0.0)
            & (y <= width - 2) & jnp.isfinite(x) & jnp.isfinite(y))

    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x0 = jnp.clip(x0, 0, width - 2)
    y0 = jnp.clip(y0, 0, width - 2)
    fx = x - x0
    fy = y - y0

    idx = y0 * width + x0
    i0 = jax.nn.sigmoid(jnp.take(logodds_flat, idx))
    i1 = jax.nn.sigmoid(jnp.take(logodds_flat, idx + 1))
    i2 = jax.nn.sigmoid(jnp.take(logodds_flat, idx + width))
    i3 = jax.nn.sigmoid(jnp.take(logodds_flat, idx + width + 1))

    xf, yf = 1.0 - fx, 1.0 - fy
    value = (i0 * xf + i1 * fx) * yf + (i2 * xf + i3 * fx) * fy
    dx1, dx2 = i0 - i1, i2 - i3
    dy1, dy2 = i0 - i2, i1 - i3
    gx = -(dx1 * xf + dx2 * fx)   # reference factor-axis quirk (see docstring)
    gy = -(dy1 * yf + dy2 * fy)

    z = jnp.zeros_like(value)
    return (jnp.where(in_b, value, z), jnp.where(in_b, gx, z),
            jnp.where(in_b, gy, z))
