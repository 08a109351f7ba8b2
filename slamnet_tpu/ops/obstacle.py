"""Obstacle-map scan update — exact order-independent scatter formulation.

Reference: UpdateObstacleMap + DrawLaserRayOnObstacleMap
(CoreSLAMProcessor.cs:456-593).  Per scan the reference walks each beam with the
symmetric Bresenham, marks traversed cells in a scratch no-hit map, increments the
endpoint cell's hit count (capped), then sweeps the whole map stepping every
no-hit-marked cell toward 0 (evidence decay).

Because hits are applied before the decay sweep and the no-hit marks are
idempotent, the per-scan result is independent of beam order, so it maps exactly to:

  hit_cnt  = scatter-add of endpoint hits
  traversed = scatter-or of intermediate cells
  v1 = min(v0 + hit_cnt, max(v0, max_hits))          # the per-beam cap, composed
  v2 = v1 +/- 1 toward zero where traversed           # the decay sweep

which reproduces the reference's semantics bit-for-bit for any beam order
(verified against a sequential golden in tests/test_obstacle.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.geometry import csharp_trunc
from .holemap import polar_lookup
from .rasterize import rosetta_line_cells


def update_obstacle_map(obstacle_map: jnp.ndarray, size: int, scale: float,
                        points: jnp.ndarray, valid: jnp.ndarray,
                        pose: jnp.ndarray, max_hits: int) -> jnp.ndarray:
    """One scan's obstacle-map update; obstacle_map: i8[size, size] (row-major y,x).

    Geometry per UpdateObstacleMap (CoreSLAMProcessor.cs:540-571): +0.5 center
    bias, C# truncation; robot outside the map skips the update (:557-560).
    """
    px = pose[0] * scale + 0.5
    py = pose[1] * scale + 0.5
    c = jnp.cos(pose[2]) * scale
    s = jnp.sin(pose[2]) * scale
    x1 = csharp_trunc(px)
    y1 = csharp_trunc(py)
    robot_in = (x1 >= 0) & (x1 < size) & (y1 >= 0) & (y1 < size)
    x1c = jnp.clip(x1, 0, size - 1)
    y1c = jnp.clip(y1, 0, size - 1)

    x2 = csharp_trunc(px + c * points[:, 0] - s * points[:, 1])
    y2 = csharp_trunc(py + s * points[:, 0] + c * points[:, 1])

    n = points.shape[0]
    begin = jnp.stack([jnp.full((n,), x1c), jnp.full((n,), y1c)], axis=1)
    end = jnp.stack([x2, y2], axis=1)
    cells, end_flat, end_ok = rosetta_line_cells(begin, end, size,
                                                max_steps=2 * size)

    ncells = size * size
    cmask = cells.mask & valid[:, None]
    traversed = jnp.zeros(ncells, jnp.int32).at[
        jnp.where(cmask, cells.flat, 0).reshape(-1)].max(
        cmask.reshape(-1).astype(jnp.int32))

    hmask = end_ok & valid
    hit_cnt = jnp.zeros(ncells, jnp.int32).at[
        jnp.where(hmask, end_flat, 0)].add(hmask.astype(jnp.int32))

    v0 = obstacle_map.reshape(-1).astype(jnp.int32)
    # per-beam "if (v < max) v++" composed over the scan: never exceeds
    # max(v0, max_hits) (CoreSLAMProcessor.cs:474-477)
    v1 = jnp.minimum(v0 + hit_cnt, jnp.maximum(v0, max_hits))
    # decay sweep (:576-592): marked cells step toward zero
    t = traversed > 0
    v2 = jnp.where(t & (v1 < 0), v1 + 1, jnp.where(t & (v1 > 0), v1 - 1, v1))

    new = v2.astype(jnp.int8).reshape(size, size)
    return jnp.where(robot_in, new, obstacle_map)


def update_obstacle_map_dense(obstacle_map: jnp.ndarray, size: int,
                              scale: float, points: jnp.ndarray,
                              valid: jnp.ndarray, pose: jnp.ndarray,
                              max_hits: int,
                              angle_bins: int = 256) -> jnp.ndarray:
    """Scatter-free obstacle update: the traversed (no-hit) region as a dense
    polar fill; endpoint hits stay an exact B-point scatter (cheap).

    Same rationale and caveat as ops/holemap.update_hole_map_dense /
    ops/logodds.update_occupancy_dense: the line mode scatters ~beams x 2 x size
    elements per scan; the swept free region is
    star-shaped, so cells strictly nearer than their sector's shortest beam
    decay toward zero — marking the whole swept polygon instead of only the
    Bresenham lines (documented divergence, opt-in via
    CoreSlamConfig.dense_obstacle_fill).  Hit counting and the cap semantics
    are identical to update_obstacle_map.
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
    x2 = csharp_trunc(px + x2p)
    y2 = csharp_trunc(py + y2p)
    dist = jnp.sqrt(x2p * x2p + y2p * y2p)
    beam_ok = valid & (dist > 1e-6)

    # endpoint hits — exact (as in the line mode)
    end_ok = (x2 >= 0) & (x2 < size) & (y2 >= 0) & (y2 < size) & valid
    end_flat = y2 * size + x2
    hit_cnt = jnp.zeros(size * size, jnp.int32).at[
        jnp.where(end_ok, end_flat, 0)].add(end_ok.astype(jnp.int32))

    # polar min-range table for the no-hit region
    ang = jnp.arctan2(y2p, x2p)
    bins = jnp.clip(((ang + jnp.pi) * (angle_bins / (2.0 * jnp.pi)))
                    .astype(jnp.int32), 0, angle_bins - 1)
    big = jnp.float32(1e9)
    table = jnp.full(angle_bins, big, jnp.float32).at[
        jnp.where(beam_ok, bins, 0)].min(jnp.where(beam_ok, dist, big))
    # "no beam" encoded as -big in the range table: one lookup per cell
    # instead of two (range + has_beam), as in ops/holemap.py
    table = jnp.where(table < big, table, -big)

    yy = jax.lax.broadcasted_iota(jnp.int32, (size, size), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (size, size), 1)
    dx = xx.astype(jnp.float32) + 0.5 - px
    dy = yy.astype(jnp.float32) + 0.5 - py
    r_c = jnp.sqrt(dx * dx + dy * dy)
    cbin = jnp.clip(((jnp.arctan2(dy, dx) + jnp.pi)
                     * (angle_bins / (2.0 * jnp.pi))).astype(jnp.int32),
                    0, angle_bins - 1)
    # strictly before the endpoint cell (the line mode's intermediate cells);
    # r_m = -big makes `traversed` false exactly where no beam hit the sector
    traversed = (r_c < polar_lookup(table, cbin) - 0.5).reshape(-1)

    v0 = obstacle_map.reshape(-1).astype(jnp.int32)
    v1 = jnp.minimum(v0 + hit_cnt, jnp.maximum(v0, max_hits))
    v2 = jnp.where(traversed & (v1 < 0), v1 + 1,
                   jnp.where(traversed & (v1 > 0), v1 - 1, v1))

    new = v2.astype(jnp.int8).reshape(size, size)
    return jnp.where(robot_in, new, obstacle_map)
