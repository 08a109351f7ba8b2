"""Hole-map scan update — CoreSLAM's hot loop #2 as a conflict-free scatter.

Reference: UpdateHoleMap + DrawLaserRayOnHoleMap (CoreSLAMProcessor.cs:496-534,
359-443).  Each beam is alpha-blended along a Bresenham walk with a V-shaped value
profile (free space at TS_NO_OBSTACLE ramping into the "hole" at the measured hit).

Array formulation: the walk + profile come from the exact closed forms in
ops/rasterize (one dense [beams, steps] tensor), and the sequential per-pixel blend
``p' = ((256-a)p + a*v) >> 8`` becomes a scatter with an analytically composed
multi-visit blend:

  - visits k and the visit-mean profile value v_bar per pixel via scatter-adds;
  - ``p' = floor(beta^k * (p - v_bar) + v_bar)`` with beta = (256-alpha)/256.

For pixels visited once (the vast majority: beams only overlap near the robot and
in hole zones of adjacent beams) this is EXACTLY the reference's integer blend.
For k-visit pixels with equal values (free space near the robot — all
TS_NO_OBSTACLE) it is exact up to the dropped intermediate floors (< k quantization
steps).  Where adjacent beams' profiles overlap with different values the
reference's result depends on beam order; the mean-composed value lies between the
order-dependent sequential outcomes — a documented, bounded divergence (see
tests/test_coreslam_ops.py tolerance check).  A bit-exact sequential-equivalent
mode is provided for parity testing.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.geometry import csharp_trunc
from .rasterize import hole_ray_cells

TS_NO_OBSTACLE = 65500
TS_OBSTACLE = 0


def update_hole_map(hole_map_flat: jnp.ndarray, size: int, scale: float,
                    points: jnp.ndarray, valid: jnp.ndarray, pose: jnp.ndarray,
                    hole_width: float, quality: int) -> jnp.ndarray:
    """One scan's hole-map update at `pose`; returns the new i32[size*size] map.

    Geometry per UpdateHoleMap (CoreSLAMProcessor.cs:498-533): +0.5 center bias,
    C# truncation to the robot pixel, per-beam hit pixel, and the endpoint extended
    past the hit by hole_width/2 along the beam.  If the robot pixel is outside the
    map the whole update is skipped (:509-512).
    """
    px = pose[0] * scale + 0.5
    py = pose[1] * scale + 0.5
    c = jnp.cos(pose[2]) * scale
    s = jnp.sin(pose[2]) * scale
    x1 = csharp_trunc(px)
    y1 = csharp_trunc(py)
    robot_in = (x1 >= 0) & (x1 < size) & (y1 >= 0) & (y1 < size)
    # clamp for safe indexing; the final `where` gate discards the clamped case
    x1c = jnp.clip(x1, 0, size - 1)
    y1c = jnp.clip(y1, 0, size - 1)

    x2p = c * points[:, 0] - s * points[:, 1]
    y2p = s * points[:, 0] + c * points[:, 1]
    xp = csharp_trunc(px + x2p)
    yp = csharp_trunc(py + y2p)
    dist = jnp.sqrt(x2p * x2p + y2p * y2p)
    beam_ok = valid & (dist > 1e-6)
    add = hole_width * scale / 2.0 / jnp.maximum(dist, 1e-6)
    x2 = csharp_trunc(px + x2p * (1.0 + add))
    y2 = csharp_trunc(py + y2p * (1.0 + add))

    rays = hole_ray_cells(x1c, y1c, x2, y2, xp, yp, TS_OBSTACLE, TS_NO_OBSTACLE,
                          size, max_steps=size)
    mask = rays.mask & beam_ok[:, None]
    flat = jnp.where(mask, rays.flat, 0)

    ncells = size * size
    visits = jnp.zeros(ncells, jnp.int32).at[flat.reshape(-1)].add(
        mask.reshape(-1).astype(jnp.int32))
    pixv = jnp.where(mask, rays.pixval, 0)
    vsum = jnp.zeros(ncells, jnp.int32).at[flat.reshape(-1)].add(
        pixv.reshape(-1))
    vbar = vsum.astype(jnp.float32) / jnp.maximum(visits, 1).astype(jnp.float32)

    beta = (256.0 - quality) / 256.0
    decay = jnp.power(beta, visits.astype(jnp.float32))
    old = hole_map_flat.astype(jnp.float32)
    blended = jnp.floor(decay * (old - vbar) + vbar).astype(jnp.int32)
    new = jnp.where(visits > 0, blended, hole_map_flat)
    return jnp.where(robot_in, new, hole_map_flat)


def polar_lookup(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """table[idx]: every cell's value from its scan's small polar-sector
    table — the per-cell lookup of all three dense fills (occupancy, hole,
    obstacle) and of the sharded CoreSLAM fill.  One gather, exact for any
    range (PERF.md has the measurement against the one-hot form)."""
    return jnp.take(table, idx)


def update_hole_map_dense(hole_map_flat: jnp.ndarray, size: int, scale: float,
                          points: jnp.ndarray, valid: jnp.ndarray,
                          pose: jnp.ndarray, hole_width: float, quality: int,
                          angle_bins: int = 256) -> jnp.ndarray:
    """Scatter-free hole-map update: the V-profile as a dense polar field.

    The line formulation above scatters ~2 x beams x size elements per scan.
    The swept region of one
    scan is star-shaped around the robot and the reference's V-profile value at
    a cell is (in radial terms) a pure function of (cell range - beam range):

        v(r) = NO_OBSTACLE                                   r <= r_hit - hw/2
               ramp down to `TS_OBSTACLE` at r_hit           |r - r_hit| < hw/2
               ramp back up to NO_OBSTACLE at r_hit + hw/2   (the extended end,
                                                              UpdateHoleMap's
                                                              `add`, :524-530)

    so instead of rasterizing beam lines we (1) scatter the B beam ranges into an
    `angle_bins` polar min-range table (a B-point scatter — cheap) and (2) blend
    EVERY cell against its sector's profile — pure dense elementwise work.

    SEMANTIC DIFFERENCES vs the line mode (documented, opt-in via
    CoreSlamConfig.dense_hole_fill): cells BETWEEN diverging beams also receive
    evidence (denser free-space/hole coverage); each cell blends at most once
    per scan (the line mode re-blends cells near the robot once per beam); the
    profile value is the exact linear ramp rather than the reference's integer
    staircase (<= 1 gray-level difference on-ray).  Matching quality is equal or
    better; parity tests use the line mode.
    """
    px = pose[0] * scale + 0.5
    py = pose[1] * scale + 0.5
    c = jnp.cos(pose[2]) * scale
    s = jnp.sin(pose[2]) * scale
    x1 = csharp_trunc(px)
    y1 = csharp_trunc(py)
    robot_in = (x1 >= 0) & (x1 < size) & (y1 >= 0) & (y1 < size)

    x2p = c * points[:, 0] - s * points[:, 1]
    y2p = s * points[:, 0] + c * points[:, 1]
    dist = jnp.sqrt(x2p * x2p + y2p * y2p)          # beam range, pixels
    beam_ok = valid & (dist > 1e-6)
    hw2 = hole_width * scale / 2.0                  # radial hole half-width, px

    # polar min-range table (conservative: nearest obstacle wins the sector)
    ang = jnp.arctan2(y2p, x2p)
    bins = jnp.clip(((ang + jnp.pi) * (angle_bins / (2.0 * jnp.pi)))
                    .astype(jnp.int32), 0, angle_bins - 1)
    big = jnp.float32(1e9)
    table = jnp.full(angle_bins, big, jnp.float32).at[
        jnp.where(beam_ok, bins, 0)].min(jnp.where(beam_ok, dist, big))
    # encode "no beam in this sector" as -big IN the range table: the per-cell
    # pass then needs ONE lookup instead of two (range + has_beam).  r_m =
    # -big makes `covered` false exactly where has_beam was false
    # (r_c >= 0 > -big+hw2).
    table = jnp.where(table < big, table, -big)

    # dense per-cell pass (cell centers at +0.5 in continuous pixel space)
    yy = jax.lax.broadcasted_iota(jnp.int32, (size, size), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (size, size), 1)
    dx = xx.astype(jnp.float32) + 0.5 - px
    dy = yy.astype(jnp.float32) + 0.5 - py
    r_c = jnp.sqrt(dx * dx + dy * dy)
    cbin = jnp.clip(((jnp.arctan2(dy, dx) + jnp.pi)
                     * (angle_bins / (2.0 * jnp.pi))).astype(jnp.int32),
                    0, angle_bins - 1)
    r_m = polar_lookup(table, cbin)
    covered = r_c < r_m + hw2

    # V-profile value at radial distance r_c
    ramp = jnp.clip(1.0 - jnp.abs(r_c - r_m) / jnp.maximum(hw2, 1e-6), 0.0, 1.0)
    v = TS_NO_OBSTACLE + (TS_OBSTACLE - TS_NO_OBSTACLE) * ramp

    old = hole_map_flat.reshape(size, size)
    blended = ((256 - quality) * old + quality * v.astype(jnp.int32)) // 256
    new = jnp.where(covered, blended, old).reshape(-1)
    return jnp.where(robot_in, new, hole_map_flat)


def update_hole_map_sequential_blend(hole_map_flat, size, scale, points, valid,
                                     pose, hole_width, quality):
    """Bit-exact sequential-equivalent mode for parity testing: identical geometry,
    but beams composited one at a time with the reference's integer blend via a
    lax.scan over beams.  O(beams) sequential steps — test/oracle use only."""
    import jax

    px = pose[0] * scale + 0.5
    py = pose[1] * scale + 0.5
    c = jnp.cos(pose[2]) * scale
    s = jnp.sin(pose[2]) * scale
    x1 = csharp_trunc(px)
    y1 = csharp_trunc(py)
    robot_in = (x1 >= 0) & (x1 < size) & (y1 >= 0) & (y1 < size)
    x1c = jnp.clip(x1, 0, size - 1)
    y1c = jnp.clip(y1, 0, size - 1)

    x2p = c * points[:, 0] - s * points[:, 1]
    y2p = s * points[:, 0] + c * points[:, 1]
    xp = csharp_trunc(px + x2p)
    yp = csharp_trunc(py + y2p)
    dist = jnp.sqrt(x2p * x2p + y2p * y2p)
    beam_ok = valid & (dist > 1e-6)
    add = hole_width * scale / 2.0 / jnp.maximum(dist, 1e-6)
    x2 = csharp_trunc(px + x2p * (1.0 + add))
    y2 = csharp_trunc(py + y2p * (1.0 + add))

    rays = hole_ray_cells(x1c, y1c, x2, y2, xp, yp, TS_OBSTACLE, TS_NO_OBSTACLE,
                          size, max_steps=size)
    mask = rays.mask & beam_ok[:, None]

    ncells = size * size

    def blend_beam(pixels, inputs):
        flat, pixval, m = inputs
        safe = jnp.where(m, flat, 0)
        old = jnp.take(pixels, safe)
        newv = ((256 - quality) * old + quality * pixval) // 256
        # masked lanes scatter out-of-bounds and are dropped; within one beam
        # every visited cell is distinct => no duplicate writers
        idx = jnp.where(m, flat, ncells)
        return pixels.at[idx].set(newv, mode="drop"), None

    out, _ = jax.lax.scan(blend_beam, hole_map_flat,
                          (rays.flat, rays.pixval, mask))
    return jnp.where(robot_in, out, hole_map_flat)
