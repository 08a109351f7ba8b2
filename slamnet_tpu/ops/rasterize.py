"""Closed-form line rasterization — the array replacement for Bresenham walks.

The reference marches rays cell-by-cell with integer error accumulators:

- CoreSLAM hole map:   DrawLaserRayOnHoleMap   (CoreSLAMProcessor.cs:359-443)
- CoreSLAM obstacles:  DrawLaserRayOnObstacleMap (CoreSLAMProcessor.cs:456-490,
  the "rosetta" symmetric variant where both axes may step per iteration)
- Hector occupancy:    Bresenham2D             (OccGridMap.cs:220-239)

Sequential per-cell walks are hostile to XLA.  All three error recurrences are
"staircase" processes — a running value accumulates a constant increment and is
knocked down by D whenever it crosses a threshold — whose overflow count after n
steps has an exact closed form (``staircase_count``).  The visited cell at step k is
therefore a pure function of k, so an entire scan rasterizes as one dense
``[beams, MAX_STEPS]`` tensor computation: no loops, no scatter ordering.  Exactness vs the reference recurrences is enforced by
tests/test_rasterize.py against step-by-step numpy goldens.

All functions are batched over beams (leading axis) and safe under jit/vmap.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.lax
import jax.numpy as jnp

from ..core.geometry import csharp_trunc


def idiv_trunc(a, b):
    """C# integer division: truncation toward zero (Python // floors instead)."""
    q = a // b
    return q + ((a % b != 0) & ((a < 0) != (b < 0)))


def staircase_count(e0, a, n, d, threshold):
    """Overflow count of the staircase recurrence after n steps (exact for a >= 0).

    Process: ``e_j = e_{j-1} + a; if e_j > threshold: e_j -= d`` for j = 1..n.
    Returns the number of times the subtraction fired, clipped to [0, n] so the
    formula stays valid even when a > d (minor axis can step at most once per
    iteration, matching the reference loops).

    For a < 0 the unconstrained count decreases with n while the true count
    freezes at its max — use ``staircase_count_cummax`` over a step axis instead.
    """
    raw = (e0 + n * a - threshold - 1) // d + 1
    return jnp.clip(raw, 0, n)


def staircase_count_cummax(e0, a, n, d, threshold, axis=-1):
    """Sign-robust overflow count: running max of the clipped staircase formula
    along the (monotone in n) step axis.  Exactness vs the sequential recurrence
    is enforced by tests/test_rasterize.py for both signs of `a`."""
    r = staircase_count(e0, a, n, d, threshold)
    return jax.lax.cummax(r, axis=axis if axis >= 0 else r.ndim + axis)


class LineCells(NamedTuple):
    """Rasterized cells: flat index per (beam, step) + validity mask."""

    flat: jnp.ndarray   # i32[B, K] flat index (y * width + x) — may be garbage where ~mask
    mask: jnp.ndarray   # bool[B, K]


def hector_line_cells(begin_xy, end_xy, width: int, max_steps: int) -> LineCells:
    """Free cells of Hector's Bresenham2D (OccGridMap.cs:155-239), vectorized.

    begin_xy/end_xy: i32[B, 2] pixel coords.  Returns the abs_da cells from begin
    toward end, endpoint EXCLUDED (the reference marks it separately as occupied).
    Beams whose begin or end is outside [0,width)x[0,height) contribute nothing
    (UpdateLineBresenhami bails, OccGridMap.cs:158-161); begin == end beams are
    skipped entirely (OccGridMap.cs:137).  Bounds masking is left to the caller
    (pass beam_valid via the mask); this computes geometry only.
    """
    dx = end_xy[:, 0] - begin_xy[:, 0]
    dy = end_xy[:, 1] - begin_xy[:, 1]
    adx, ady = jnp.abs(dx), jnp.abs(dy)
    sx, sy = jnp.sign(dx), jnp.sign(dy)

    x_major = adx >= ady
    maj = jnp.where(x_major, adx, ady)                       # abs_da
    mino = jnp.where(x_major, ady, adx)                      # abs_db
    off_major = jnp.where(x_major, sx, sy * width)
    off_minor = jnp.where(x_major, sy * width, sx)
    e0 = maj // 2                                            # error_y / error_x init

    k = jnp.arange(max_steps, dtype=jnp.int32)[None, :]      # [1, K]
    safe_maj = jnp.maximum(maj, 1)[:, None]
    # minor steps before drawing cell k: check-after-increment, >= threshold —
    # m_k = floor((e0 + k*abs_db) / abs_da), exact (see module docstring).
    m = (e0[:, None] + k * mino[:, None]) // safe_maj
    start = begin_xy[:, 1] * width + begin_xy[:, 0]
    flat = start[:, None] + k * off_major[:, None] + m * off_minor[:, None]
    mask = (k < maj[:, None]) & (maj[:, None] > 0)
    return LineCells(flat, mask)


def rosetta_line_cells(begin_xy, end_xy, size: int, max_steps: int):
    """Cells of the symmetric Bresenham used for the obstacle map
    (DrawLaserRayOnObstacleMap, CoreSLAMProcessor.cs:456-490).

    Both axes may advance in one iteration (diagonal steps).  The walk visits
    max(|dx|, |dy|) intermediate cells then the endpoint; it stops at the first
    out-of-map cell (monotone path from an in-map start can never re-enter, so a
    plain per-cell bounds check is exact).

    Returns (cells: LineCells for the intermediate "no-hit" cells,
             end_flat: i32[B] endpoint flat index,
             end_ok: bool[B] endpoint reached while in-map).
    """
    dx = end_xy[:, 0] - begin_xy[:, 0]
    dy = end_xy[:, 1] - begin_xy[:, 1]
    adx, ady = jnp.abs(dx), jnp.abs(dy)
    sx, sy = jnp.sign(dx), jnp.sign(dy)

    x_major = adx > ady                                      # err = (dx>dy ? dx : -dy)/2
    maj = jnp.maximum(adx, ady)
    mino = jnp.minimum(adx, ady)
    e0 = jnp.where(x_major, adx // 2, ady // 2)              # |err| of the C# init
    # (C# (−dy)/2 truncates toward zero = −(dy//2); the mirrored recurrence uses dy//2.)

    k = jnp.arange(max_steps, dtype=jnp.int32)[None, :]
    safe_maj = jnp.maximum(maj, 1)[:, None]
    # minor steps before visiting cell k: fire condition err < minor checked after
    # the major-axis update — m_k = floor((k*mino - e0 + maj - 1) / maj), exact.
    m = (k * mino[:, None] - e0[:, None] + safe_maj - 1) // safe_maj
    m = jnp.clip(m, 0, k)

    x = jnp.where(x_major[:, None],
                  begin_xy[:, 0:1] + k * sx[:, None],
                  begin_xy[:, 0:1] + m * sx[:, None])
    y = jnp.where(x_major[:, None],
                  begin_xy[:, 1:2] + m * sy[:, None],
                  begin_xy[:, 1:2] + k * sy[:, None])

    in_map = (x >= 0) & (x < size) & (y >= 0) & (y < size)
    cells_mask = (k < maj[:, None]) & in_map
    flat = y * size + x

    end_flat = end_xy[:, 1] * size + end_xy[:, 0]
    end_ok = ((end_xy[:, 0] >= 0) & (end_xy[:, 0] < size) &
              (end_xy[:, 1] >= 0) & (end_xy[:, 1] < size))
    return LineCells(flat, cells_mask), end_flat, end_ok


def clip_ray_endpoint(x1, y1, x2, y2, size: int):
    """CoreSLAM's ClipRay pair (CoreSLAMProcessor.cs:320-345,365-366), vectorized.

    Clips the (x2, y2) end of the segment from (x1, y1) to the map box using the
    reference's exact integer arithmetic (C# truncating division).  Returns
    (x2c, y2c, ok); ok=False reproduces the early-return (degenerate clip).
    """
    def clip_axis(xyc, yxc, xy, yx):
        # first branch: xyc < 0
        lo = xyc < 0
        denom = jnp.where(xyc == xy, 1, xyc - xy)
        yxc1 = yxc + idiv_trunc((yxc - yx) * (-xyc), denom)
        bad_lo = lo & (xyc == xy)
        yxc = jnp.where(lo, yxc1, yxc)
        xyc = jnp.where(lo, 0, xyc)
        # second branch: xyc >= size
        hi = xyc >= size
        denom = jnp.where(xyc == xy, 1, xyc - xy)
        yxc2 = yxc + idiv_trunc((yxc - yx) * (size - 1 - xyc), denom)
        bad_hi = hi & (xyc == xy)
        yxc = jnp.where(hi, yxc2, yxc)
        xyc = jnp.where(hi, size - 1, xyc)
        return xyc, yxc, ~(bad_lo | bad_hi)

    x2c, y2c, ok1 = clip_axis(x2, y2, x1, y1)
    y2c, x2c, ok2 = clip_axis(y2c, x2c, y1, x1)
    return x2c, y2c, ok1 & ok2


class HoleRay(NamedTuple):
    """Rasterized hole-map rays: per (beam, step) flat pointer, V-profile value, mask."""

    flat: jnp.ndarray    # i32[B, K]
    pixval: jnp.ndarray  # i32[B, K] — the V-profile value blended at that cell
    mask: jnp.ndarray    # bool[B, K]


def hole_ray_cells(x1, y1, x2, y2, xp, yp, value: int, no_obstacle: int,
                   size: int, max_steps: int) -> HoleRay:
    """DrawLaserRayOnHoleMap's traversal + V-profile (CoreSLAMProcessor.cs:359-443),
    fully vectorized and exact vs the reference recurrences.

    x1,y1: scalar robot pixel (shared); x2,y2: i32[B] extended endpoints;
    xp,yp: i32[B] measured hit points; value: the obstacle value (TS_OBSTACLE=0);
    no_obstacle: TS_NO_OBSTACLE=65500.
    """
    x2 = jnp.asarray(x2, jnp.int32)
    y2 = jnp.asarray(y2, jnp.int32)
    b = x2.shape[0]
    x1b = jnp.full((b,), x1, jnp.int32)
    y1b = jnp.full((b,), y1, jnp.int32)

    x2c, y2c, clip_ok = clip_ray_endpoint(x1b, y1b, x2, y2, size)

    dx, dy = jnp.abs(x2 - x1b), jnp.abs(y2 - y1b)
    dxc, dyc = jnp.abs(x2c - x1b), jnp.abs(y2c - y1b)
    incptrx = jnp.sign(x2 - x1b)
    incptry = jnp.sign(y2 - y1b) * size
    sincv = jnp.sign(value - no_obstacle)

    x_major = dx > dy
    derrorv = jnp.where(x_major, jnp.abs(xp - x2), jnp.abs(yp - y2))
    # axis swap (CoreSLAMProcessor.cs:383-386): dx<-dy, (dxc,dyc) swap, incptr swap
    dxs = jnp.where(x_major, dx, dy)
    dxcs = jnp.where(x_major, dxc, dyc)
    dycs = jnp.where(x_major, dyc, dxc)
    inc_major = jnp.where(x_major, incptrx, incptry)
    inc_minor = jnp.where(x_major, incptry, incptrx)

    beam_ok = clip_ok & (derrorv != 0)
    sd = jnp.maximum(derrorv, 1)

    # V-profile increments with C# truncating division (":398-399")
    vn = value - no_obstacle
    incv = idiv_trunc(vn, sd)
    incerrorv = vn - sd * incv

    k = jnp.arange(max_steps, dtype=jnp.int32)[None, :]
    dxs_, dxcs_, dycs_ = dxs[:, None], dxcs[:, None], dycs[:, None]
    sd_ = sd[:, None]

    # ---- traversal: error starts 2*dyc - dxc, minor steps via the staircase form
    e0 = 2 * dycs_ - dxcs_
    safe_d = jnp.maximum(2 * dxcs_, 1)
    # strict "error > 0" check => the -1 inside the floor
    m = jnp.clip((e0 + (k - 1) * 2 * dycs_ - 1) // safe_d + 1, 0, k)
    start = y1 * size + x1
    flat = start + k * inc_major[:, None] + m * inc_minor[:, None]

    # ---- V-profile value at step k (":404-428"), exact closed forms
    ramp_start = dxs_ - 2 * sd_          # pixval changes for k > ramp_start
    bottom = dxs_ - sd_                  # down-leg for k <= bottom, up-leg after
    # the ramp window can begin before iteration 0 (short beams / overshooting
    # hit points) — only iterations x >= 0 actually execute profile steps
    ramp_lo = jnp.maximum(ramp_start + 1, 0)     # first iteration with a down-step
    total_down = jnp.maximum(bottom - ramp_lo + 1, 0)
    n_down = jnp.clip(k - ramp_lo + 1, 0, total_down)
    n_up = jnp.clip(k - jnp.maximum(bottom, -1), 0, None)

    e0v = sd_ // 2                               # errorv = derrorv / 2
    a = incerrorv[:, None]
    # down-leg overflows: check-after-add, strict "> derrorv"
    o_down = staircase_count_cummax(e0v, a, n_down, sd_, sd_)
    # error value entering the up-leg (after the executed down-steps); the full
    # down-leg count is the running max at saturation (n_down covers 0..total_down)
    o_down_full = o_down[:, -1:]
    e_end = e0v + total_down * a - sd_ * o_down_full
    # up-leg overflows: "errorv -= incerrorv; if errorv < 0: +=" — negate to the
    # same staircase with threshold 0
    o_up = staircase_count_cummax(-e_end, a, n_up, sd_, 0)

    pixval = (no_obstacle
              + n_down * incv[:, None] + sincv * o_down
              - n_up * incv[:, None] - sincv * o_up)

    mask = (k <= dxcs_) & beam_ok[:, None]
    return HoleRay(flat, pixval, mask)
