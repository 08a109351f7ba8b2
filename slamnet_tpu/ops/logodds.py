"""Log-odds occupancy update — Hector's hot loop #4 as an order-independent scatter.

Reference: OccGridMap.UpdateByScan + UpdateLineBresenhami + BresenhamCellFree/Occ
(OccGridMap.cs:114-239).  The reference walks each beam marking free cells
(+logOddsFree, at most once per scan via the UpdateIndex generation counter) and
the endpoint occupied (+logOddsOccupied, capped at value < 50, REVERTING a
same-scan free mark first).

Those generation-counter rules make the per-scan result independent of beam order:

  cell in occ set                -> + logOddsOccupied if value < 50
  cell in free set, not occ set  -> + logOddsFree

so the whole scan becomes two scattered boolean masks + one vectorized update —
exact (bit-for-bit) vs the sequential semantics, verified in tests/test_hector_ops.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.geometry import dotnet_round
from .holemap import polar_lookup
from .rasterize import hector_line_cells


def update_occupancy(logodds_flat: jnp.ndarray, width: int, points: jnp.ndarray,
                     valid: jnp.ndarray, robot_pose_world: jnp.ndarray,
                     scan_pose: jnp.ndarray, scale_to_map: float,
                     log_odds_free: float, log_odds_occupied: float,
                     occupied_cap: float = 50.0) -> jnp.ndarray:
    """One scan's occupancy update; returns new f32[width*width] log-odds map.

    Geometry per UpdateByScan (OccGridMap.cs:119-141): p_map = (R(theta)*p + t) *
    scale_to_map rounded half-to-even (.NET ToRoundPoint); beam start is the
    transformed scan-cloud pose (zero in the simulator => the robot cell); beams
    with begin == end or with either end outside the dimensions are skipped.
    """
    theta = robot_pose_world[2]
    c, s = jnp.cos(theta), jnp.sin(theta)
    tx, ty = robot_pose_world[0], robot_pose_world[1]

    bx = (c * scan_pose[0] - s * scan_pose[1] + tx) * scale_to_map
    by = (s * scan_pose[0] + c * scan_pose[1] + ty) * scale_to_map
    begin = jnp.stack([dotnet_round(bx), dotnet_round(by)])

    ex = (c * points[:, 0] - s * points[:, 1] + tx) * scale_to_map
    ey = (s * points[:, 0] + c * points[:, 1] + ty) * scale_to_map
    end = jnp.stack([dotnet_round(ex), dotnet_round(ey)], axis=1)

    n = points.shape[0]
    begin_b = jnp.broadcast_to(begin, (n, 2))
    same = (end[:, 0] == begin[0]) & (end[:, 1] == begin[1])
    in_dims = lambda p: ((p[..., 0] >= 0) & (p[..., 0] < width) &
                         (p[..., 1] >= 0) & (p[..., 1] < width))
    beam_ok = valid & ~same & in_dims(begin_b) & in_dims(end)

    cells = hector_line_cells(begin_b, end, width, max_steps=width)
    fmask = cells.mask & beam_ok[:, None]

    ncells = width * width
    free = jnp.zeros(ncells, jnp.int32).at[
        jnp.where(fmask, cells.flat, 0).reshape(-1)].max(
        fmask.reshape(-1).astype(jnp.int32))
    end_flat = end[:, 1] * width + end[:, 0]
    occ = jnp.zeros(ncells, jnp.int32).at[
        jnp.where(beam_ok, end_flat, 0)].max(beam_ok.astype(jnp.int32))

    is_occ = occ > 0
    is_free = (free > 0) & ~is_occ
    return (logodds_flat
            + jnp.where(is_free, log_odds_free, 0.0)
            + jnp.where(is_occ & (logodds_flat < occupied_cap),
                        log_odds_occupied, 0.0))


def update_occupancy_dense(logodds_flat: jnp.ndarray, width: int,
                           points: jnp.ndarray, valid: jnp.ndarray,
                           robot_pose_world: jnp.ndarray,
                           scan_pose: jnp.ndarray, scale_to_map: float,
                           log_odds_free: float, log_odds_occupied: float,
                           occupied_cap: float = 50.0,
                           angle_bins: int = 256,
                           free_margin_px: float = 0.75) -> jnp.ndarray:
    """Scatter-free occupancy update: free space as a dense polygon fill.

    The line fill scatters ~B*len cells per scan, which dominates mapping-heavy
    workloads (fleet mode, update-every-scan).  The free region of one scan is
    star-shaped around the robot, so instead of rasterizing B beam lines we:

      1. scatter the B beam ranges into an `angle_bins` polar range table
         (a B-point scatter — cheap);
      2. for EVERY cell compute (range, angle) to the robot and mark it free iff
         its range is under the table entry for its angle bin minus
         `free_margin_px` — pure dense elementwise work.

    SEMANTIC DIFFERENCE vs the reference (documented, opt-in): beam lines mark
    only the ~B*len cells ON the Bresenham lines; the dense fill marks the whole
    swept polygon, so cells BETWEEN diverging beams (farther than ~bins/(2*pi)
    cells out) also receive free evidence.  Occupied endpoints are identical.
    Matching quality is equal or better (denser evidence); parity tests use the
    line mode.

    `free_margin_px` (WALL-EROSION GUARD, round 5): the dense fill paints free
    up to the measured range EVERY update in the whole sector, so with range
    noise the cells around a wall are repeatedly freed and walls erode to a
    one-cell ridge with strongly-free neighbors — the matcher's convergence
    basin narrows, and one bad hint (an odometry slip) locks onto a false
    minimum it never leaves.  Measured on the adversarial 180-degree log
    (slips + dropout, PERF.md): margin 0.5 px -> 0.208 m rms (6x worse
    than line mode); 0.75 (default) -> 0.038; 1.5 -> 0.021; 2.0 -> 0.015.
    The default is the largest value holding the CLEAN bench's strict ATE
    gate (margin sweep, PERF.md round 5); raise to 1.5-2.0 for
    degraded sensors.  The margin leaves a moat of unknown cells in front
    of measured surfaces instead of freeing them.
    """
    theta = robot_pose_world[2]
    c, s = jnp.cos(theta), jnp.sin(theta)
    tx, ty = robot_pose_world[0], robot_pose_world[1]
    bx = (c * scan_pose[0] - s * scan_pose[1] + tx) * scale_to_map
    by = (s * scan_pose[0] + c * scan_pose[1] + ty) * scale_to_map
    bxi, byi = dotnet_round(bx), dotnet_round(by)

    ex = (c * points[:, 0] - s * points[:, 1] + tx) * scale_to_map
    ey = (s * points[:, 0] + c * points[:, 1] + ty) * scale_to_map
    exi, eyi = dotnet_round(ex), dotnet_round(ey)

    in_dims = lambda x, y: (x >= 0) & (x < width) & (y >= 0) & (y < width)
    same = (exi == bxi) & (eyi == byi)
    beam_ok = valid & ~same & in_dims(bxi, byi) & in_dims(exi, eyi)

    # polar range table: per angle bin, the MIN valid beam range (px) —
    # conservative: free is marked only up to the shortest beam in the bin,
    # and bins with no valid beam stay at 0 (no free marking in that sector).
    # `angle_bins` must stay below the beam count so bins are covered.
    dxe = (exi - bxi).astype(jnp.float32)
    dye = (eyi - byi).astype(jnp.float32)
    r_beam = jnp.sqrt(dxe * dxe + dye * dye)
    ang = jnp.arctan2(dye, dxe)                        # (-pi, pi]
    bins = ((ang + jnp.pi) * (angle_bins / (2.0 * jnp.pi))).astype(jnp.int32)
    bins = jnp.clip(bins, 0, angle_bins - 1)
    big = jnp.float32(1e9)
    table = jnp.full(angle_bins, big, jnp.float32).at[
        jnp.where(beam_ok, bins, 0)].min(jnp.where(beam_ok, r_beam, big))
    table = jnp.where(table >= big, 0.0, table)

    # dense per-cell test
    yy = jax.lax.broadcasted_iota(jnp.int32, (width, width), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (width, width), 1)
    dx = (xx - bxi).astype(jnp.float32)
    dy = (yy - byi).astype(jnp.float32)
    r_cell = jnp.sqrt(dx * dx + dy * dy)
    cang = jnp.arctan2(dy, dx)
    cbin = jnp.clip(((cang + jnp.pi) * (angle_bins / (2.0 * jnp.pi)))
                    .astype(jnp.int32), 0, angle_bins - 1)
    r_lim = polar_lookup(table, cbin)
    is_free_img = (r_cell < r_lim - free_margin_px) & (r_cell > 0.0)

    # occupied endpoints: a B-point scatter (cheap)
    end_flat = eyi * width + exi
    occ = jnp.zeros(width * width, jnp.int32).at[
        jnp.where(beam_ok, end_flat, 0)].max(beam_ok.astype(jnp.int32))

    any_beam = jnp.any(beam_ok)
    is_occ = occ > 0
    is_free = is_free_img.reshape(-1) & ~is_occ & any_beam
    return (logodds_flat
            + jnp.where(is_free, log_odds_free, 0.0)
            + jnp.where(is_occ & (logodds_flat < occupied_cap),
                        log_odds_occupied, 0.0))
