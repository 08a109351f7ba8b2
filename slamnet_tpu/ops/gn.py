"""Gauss-Newton scan matching pieces: Hessian accumulation + guarded 3x3 solve.

Reference: ScanMatcher.GetCompleteHessianDerivs + EstimateTransformationLogLh
(ScanMatcher.cs:93-204).  The reference chunks beams over a thread pool and sums
partial (H, dTr) on the host; here the accumulation is one masked sum over the
beam axis (vmap semantics) — the same reduction the beam-sharded multi-device
path psums across devices (SURVEY.md §2.5 P3).

The reference solves with a 4x4 inverse because .NET lacks 3x3 (README.md:33,
ScanMatcher.cs:203 sets M44=1); here the 3x3 symmetric system is solved directly
via the adjugate.  Guards reproduced: H00 != 0 && H11 != 0 (ScanMatcher.cs:97),
non-invertible H skips the step (:99-103), and the rotation component of the step
is clamped to +/-0.2 rad (:107-117).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .bilinear import interp_value_and_gradients


def hessian_derivs(logodds_flat: jnp.ndarray, width: int, points: jnp.ndarray,
                   valid: jnp.ndarray, pose_px: jnp.ndarray,
                   scale_to_map: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Accumulate (H f32[3,3], dTr f32[3]) at map-pixel pose `pose_px`.

    points: f32[N,2] robot-local meters.  Transform per ScanMatcher.cs:139-146:
    p_map = R(theta) * p * scale_to_map + (x_px, y_px); the rotation derivative
    uses the raw metric point with sin/cos pre-scaled by scale_to_map.
    """
    theta = pose_px[2]
    sin_r = jnp.sin(theta) * scale_to_map
    cos_r = jnp.cos(theta) * scale_to_map

    X, Y = points[:, 0], points[:, 1]
    mx = cos_r * X - sin_r * Y + pose_px[0]
    my = sin_r * X + cos_r * Y + pose_px[1]
    coords = jnp.stack([mx, my], axis=1)

    value, gx, gy = interp_value_and_gradients(logodds_flat, width, coords, valid)
    fun = 1.0 - value
    rot = (-sin_r * X - cos_r * Y) * gx + (cos_r * X - sin_r * Y) * gy

    dtr = jnp.stack([jnp.sum(gx * fun), jnp.sum(gy * fun), jnp.sum(rot * fun)])
    h00 = jnp.sum(gx * gx)
    h11 = jnp.sum(gy * gy)
    h22 = jnp.sum(rot * rot)
    h01 = jnp.sum(gx * gy)
    h02 = jnp.sum(gx * rot)
    h12 = jnp.sum(gy * rot)
    H = jnp.array([[h00, h01, h02], [h01, h11, h12], [h02, h12, h22]])
    return H, dtr


def solve_gn_step(H: jnp.ndarray, dtr: jnp.ndarray,
                  deriv_clamp: float = 0.2) -> jnp.ndarray:
    """Guarded symmetric 3x3 solve, rotation step clamped; zero step on failure.

    Vectorized via cross-products (adj(H) rows are cross products of H's rows):
    ~8 tensor ops instead of ~25 scalar ops.
    """
    adj = jnp.stack([jnp.cross(H[1], H[2]), jnp.cross(H[2], H[0]),
                     jnp.cross(H[0], H[1])])
    det = jnp.dot(H[0], adj[0])
    ok = (H[0, 0] != 0.0) & (H[1, 1] != 0.0) & (det != 0.0) & jnp.isfinite(det)
    inv_det = jnp.where(ok, 1.0 / jnp.where(det == 0.0, 1.0, det), 0.0)
    step = (adj @ dtr) * inv_det           # adj is symmetric => adj == adj^T
    step = step.at[2].set(jnp.clip(step[2], -deriv_clamp, deriv_clamp))
    return jnp.where(ok, step, jnp.zeros(3))


def _solve_scalar(H00, H01, H02, H11, H12, H22, d0, d1, d2, clamp,
                  xy_clamp: float = 0.0, damping: float = 0.0):
    """solve_gn_step on unpacked scalars — same math, no stack/cross/matmul ops.

    Fewer, simpler ops than the stacked form in a hot loop bound by op
    scheduling; private to the fused matchers (and the kernel,
    ops/pallas_match.py), the public solve_gn_step stays the readable API.

    damping > 0 is a Levenberg-style robustness extension (NOT in the
    reference): H's diagonal is scaled by (1 + damping), which shrinks the
    step along poorly-observed directions (a straight corridor makes H nearly
    singular along the corridor axis, and the unregularized step can throw
    the pose off-map — the reference has the same failure mode, README.md:39).

    Returns (s0, s1, s2, ok) — ok mirrors the reference's solve guards
    (ScanMatcher.cs:97-103): when False the step is zero and the caller may
    count/log the failure (the reference logs "H is not invertible").
    """
    if damping > 0.0:
        H00 = H00 * (1.0 + damping)
        H11 = H11 * (1.0 + damping)
        H22 = H22 * (1.0 + damping)
    a0 = H11 * H22 - H12 * H12            # adjugate upper triangle
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
    if xy_clamp > 0.0:
        # robustness extension (NOT in the reference, which clamps theta only,
        # ScanMatcher.cs:107-117): bound the translation step so a
        # near-singular H in a degenerate view cannot throw the pose off-map
        # (an off-map pose is unrecoverable — every gather masks out)
        s0 = jnp.clip(s0, -xy_clamp, xy_clamp)
        s1 = jnp.clip(s1, -xy_clamp, xy_clamp)
    s2 = jnp.clip((a2 * d0 + b2 * d1 + c2 * d2) * inv, -clamp, clamp)
    return s0, s1, s2, ok


def gn_iteration(logodds_flat, width, points, valid, pose_px, scale_to_map,
                 deriv_clamp: float = 0.2):
    """One EstimateTransformationLogLh step: pose_px += clamped H^-1 dTr."""
    H, dtr = hessian_derivs(logodds_flat, width, points, valid, pose_px,
                            scale_to_map)
    return pose_px + solve_gn_step(H, dtr, deriv_clamp)


# ---------------------------------------------------------------------------
# Fused pyramid matcher — the production hot path.
#
# Same semantics as match-over-gn_iteration, as few fused ops as possible:
#   * all pyramid levels live in ONE concatenated flat table, so every GN
#     iteration is a single gather operand (XLA hoists the table prep once);
#   * the 4 bilinear neighbors are ONE stacked [4, N] gather, not 4;
#   * the 9 Hessian/residual sums are ONE fused [9, N] reduction;
#   * the beam axis is padded to a multiple of 128 by the caller (512 for
#     400-ray scans).
# The whole match as one kernel is ops/pallas_match.py (matcher_mode="pallas").
# ---------------------------------------------------------------------------

def _gn_coords(width, scale, pose_px, X, Y, valid):
    """Shared coordinate/mask prep for both gather modes."""
    sr = jnp.sin(pose_px[2]) * scale
    cr = jnp.cos(pose_px[2]) * scale
    mx = cr * X - sr * Y + pose_px[0]
    my = sr * X + cr * Y + pose_px[1]
    ok = valid & (mx >= 0.0) & (mx <= width - 2) & (my >= 0.0) & (my <= width - 2)
    xi = jnp.clip(mx.astype(jnp.int32), 0, width - 2)
    yi = jnp.clip(my.astype(jnp.int32), 0, width - 2)
    return sr, cr, mx, my, ok, xi, yi


def _gn_rows(v, mx, my, xi, yi, ok, X, Y, sr, cr, with_stats):
    """Per-beam terms of the GN normal equations from the 4 bilinear
    neighbor probabilities v[0..3]: the 9 (dTr, H) rows, plus the residual
    and in-bounds rows when `with_stats`.  Shared by every matcher form."""
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
    rows = [gx * fun, gy * fun, rot * fun,
            gx * gx, gx * gy, gx * rot,
            gy * gy, gy * rot, rot * rot]
    if with_stats:
        rows += [fun * fun, ok.astype(jnp.float32)]
    return rows


def _gn_tail(v, mx, my, xi, yi, ok, X, Y, sr, cr, pose_px, deriv_clamp,
             with_stats, xy_clamp, damping):
    """From the 4 gathered neighbor probabilities v f32[4, N] to the solved
    step — identical for every gather implementation."""
    rows = _gn_rows(v, mx, my, xi, yi, ok, X, Y, sr, cr, with_stats)
    red = jnp.stack(rows).sum(axis=1)
    d0, d1, d2, H00, H01, H02, H11, H12, H22 = red[:9]
    s0, s1, s2, solve_ok = _solve_scalar(H00, H01, H02, H11, H12, H22,
                                         d0, d1, d2, deriv_clamp, xy_clamp,
                                         damping)
    new_pose = jnp.stack([pose_px[0] + s0, pose_px[1] + s1, pose_px[2] + s2])
    if with_stats:
        return new_pose, solve_ok, red[9], red[10]
    return new_pose


def _fused_gn_core(table, offset, width, scale, pose_px, X, Y, valid,
                   deriv_clamp, with_stats: bool, xy_clamp: float = 0.0,
                   damping: float = 0.0):
    """Shared body of the fused GN step; `with_stats` is a trace-time flag —
    when False the stats rows are never built (zero cost on the plain path).

    The 9 Hessian/residual sums run as ONE [9, N] stacked reduction and the
    solve on unpacked scalars (_gn_tail).  The stats rows are
    the matcher-health channel (ScanMatcher.cs:99-115 logging parity)."""
    sr, cr, mx, my, ok, xi, yi = _gn_coords(width, scale, pose_px, X, Y, valid)
    base = offset + yi * width + xi
    idx = jnp.stack([base, base + 1, base + width, base + width + 1])
    v = jax.nn.sigmoid(jnp.take(table, idx))
    return _gn_tail(v, mx, my, xi, yi, ok, X, Y, sr, cr, pose_px, deriv_clamp,
                    with_stats, xy_clamp, damping)


# ---------------------------------------------------------------------------
# One-hot matmul gather variant.
#
# Written for an accelerator whose gather serialized on a loop-variant table
# (the map is a carried state): the chained gather becomes two one-hot ROW
# matmuls per iteration (rows yi and yi+1 of a per-level padded table view
# built once per match) plus a lane-select.  On the GPU it is the slowest
# matcher (PERF.md); it stays until a PR removes it with its bench rows.
#
# The row tables are PER LEVEL: a single stacked all-levels table made every
# GN iteration pay [2N, 700] x [700, 512] regardless of level.  The pyramid
# loop unrolls at trace time, so each level multiplies against its own
# [w_l, lanes_l] table (lanes_l = w_l rounded up to 128) instead.
#
# Exactness: a one-hot row selects a single table entry (1.0*x plus exact
# zeros), so with full-precision matmuls the selected neighbor values — and
# therefore the whole match — are BIT-IDENTICAL to the take()-based kernel
# (tests/test_hector_ops.py); `precision="default"` instead rounds the table
# to bf16 (~0.4% value noise, ATE-gated in bench.py before it can become the
# headline).
# ---------------------------------------------------------------------------

def level_lanes(width: int) -> int:
    """Lane-tile-aligned table width for one pyramid level."""
    return max(128, -(-width // 128) * 128)


def build_row_tables(table: jnp.ndarray, cfg) -> Tuple[jnp.ndarray, ...]:
    """Per-level lane-padded row tables: level l -> f32[w_l, lanes_l].
    Built once per match call, loop-invariant across GN iterations."""
    parts = []
    for level in range(cfg.num_levels):
        w = cfg.level_sizes[level]
        off = cfg.level_offsets[level]
        g = table[off:off + w * w].reshape(w, w)
        parts.append(jnp.pad(g, ((0, 0), (0, level_lanes(w) - w))))
    return tuple(parts)


def fused_gn_iteration_onehot_stats(table2d: jnp.ndarray, row_off: int,
                                    width: int, scale: float, pose_px,
                                    X, Y, valid, deriv_clamp: float = 0.2,
                                    xy_clamp: float = 0.0,
                                    damping: float = 0.0,
                                    precision: str = "highest"):
    """fused_gn_iteration_stats with the gather as one-hot matmuls.

    table2d: ONE level's row table (build_row_tables output; row_off=0), or
    any [R, lanes] view with this level's rows starting at row_off."""
    sr, cr, mx, my, ok, xi, yi = _gn_coords(width, scale, pose_px, X, Y, valid)
    n = X.shape[0]
    total_rows = table2d.shape[0]
    lanes = table2d.shape[1]

    # bf16 mode builds the one-hot masks (and table operand) in bf16: 0/1 are
    # exact in bf16 and the table is rounded anyway, so semantics are
    # unchanged while the mask materialization moves half the bytes
    oh_dt = jnp.float32 if precision == "highest" else jnp.bfloat16
    ry = row_off + yi
    rsel = jnp.concatenate([ry, ry + 1])                      # [2N]
    oh_rows = (rsel[:, None]
               == jnp.arange(total_rows, dtype=ry.dtype)).astype(oh_dt)
    prec = (jax.lax.Precision.HIGHEST if precision == "highest" else None)
    tbl = table2d if precision == "highest" else table2d.astype(oh_dt)
    sel = jnp.dot(oh_rows, tbl, precision=prec).astype(jnp.float32)

    lane = jnp.arange(lanes, dtype=xi.dtype)
    oh0 = (xi[:, None] == lane).astype(oh_dt)                 # [N, lanes]
    oh1 = ((xi + 1)[:, None] == lane).astype(oh_dt)
    r0, r1 = sel[:n], sel[n:]
    raw = jnp.stack([(r0 * oh0).sum(axis=1), (r0 * oh1).sum(axis=1),
                     (r1 * oh0).sum(axis=1),
                     (r1 * oh1).sum(axis=1)]).astype(jnp.float32)
    v = jax.nn.sigmoid(raw)
    return _gn_tail(v, mx, my, xi, yi, ok, X, Y, sr, cr, pose_px, deriv_clamp,
                    True, xy_clamp, damping)


def fused_gn_iteration(table: jnp.ndarray, offset: int, width: int,
                       scale: float, pose_px: jnp.ndarray, X, Y, valid,
                       deriv_clamp: float = 0.2,
                       xy_clamp: float = 0.0,
                       damping: float = 0.0) -> jnp.ndarray:
    """One GN step against the level at `offset` inside the concatenated table."""
    return _fused_gn_core(table, offset, width, scale, pose_px, X, Y, valid,
                          deriv_clamp, with_stats=False, xy_clamp=xy_clamp,
                          damping=damping)


def fused_gn_iteration_stats(table: jnp.ndarray, offset: int, width: int,
                             scale: float, pose_px: jnp.ndarray, X, Y, valid,
                             deriv_clamp: float = 0.2, xy_clamp: float = 0.0,
                             damping: float = 0.0):
    """fused_gn_iteration + matcher health: returns
    (new_pose f32[3], solve_ok bool, resid_sum f32 = sum (1-M(p))^2 over
    in-bounds valid beams, n_in f32 = that beam count)."""
    return _fused_gn_core(table, offset, width, scale, pose_px, X, Y, valid,
                          deriv_clamp, with_stats=True, xy_clamp=xy_clamp,
                          damping=damping)


def fused_gn_iteration_batch(flat: jnp.ndarray, cells: int, offset: int,
                             width: int, scale: float, poses_px: jnp.ndarray,
                             X, Y, valid, deriv_clamp: float = 0.2,
                             xy_clamp: float = 0.0, damping: float = 0.0):
    """One GN step for B instances at once — the fleet matcher hot loop.

    flat f32[B*cells] — ALL instance pyramids as ONE flat array (the caller
    carries it flat; never reshape a [B, C] carry here, a reshape inside the
    per-iteration loop forces a relayout of the whole table per GN step);
    poses_px f32[B, 3]; X/Y f32[B, N]; valid bool[B, N].

    NOT a vmap of fused_gn_iteration: a vmapped (batched-operand) gather can
    lower to a per-instance loop.  The bilinear neighbors are ONE non-batched [4, B, N]
    gather with explicit b*cells + idx indices — the same lowering that makes
    the unbatched matcher fast.  Returns (new_poses f32[B,3], solve_ok bool[B],
    resid_sum f32[B], n_in f32[B]).
    """
    b = poses_px.shape[0]
    sr = jnp.sin(poses_px[:, 2]) * scale            # [B]
    cr = jnp.cos(poses_px[:, 2]) * scale
    mx = cr[:, None] * X - sr[:, None] * Y + poses_px[:, 0][:, None]   # [B, N]
    my = sr[:, None] * X + cr[:, None] * Y + poses_px[:, 1][:, None]
    ok = valid & (mx >= 0.0) & (mx <= width - 2) & (my >= 0.0) \
        & (my <= width - 2)
    xi = jnp.clip(mx.astype(jnp.int32), 0, width - 2)
    yi = jnp.clip(my.astype(jnp.int32), 0, width - 2)
    base = (jnp.arange(b, dtype=jnp.int32)[:, None] * cells
            + offset + yi * width + xi)
    idx = jnp.stack([base, base + 1, base + width, base + width + 1])
    v = jax.nn.sigmoid(jnp.take(flat, idx))        # [4, B, N]
    fx = mx - xi
    fy = my - yi
    xf, yf = 1.0 - fx, 1.0 - fy
    val = (v[0] * xf + v[1] * fx) * yf + (v[2] * xf + v[3] * fx) * fy
    gx = -((v[0] - v[1]) * xf + (v[2] - v[3]) * fx)
    gy = -((v[0] - v[2]) * yf + (v[1] - v[3]) * fy)
    z = jnp.float32(0.0)
    gx = jnp.where(ok, gx, z)
    gy = jnp.where(ok, gy, z)
    fun = jnp.where(ok, 1.0 - val, z)
    rot = (-sr[:, None] * X - cr[:, None] * Y) * gx \
        + (cr[:, None] * X - sr[:, None] * Y) * gy
    red = jnp.stack([gx * fun, gy * fun, rot * fun,
                     gx * gx, gx * gy, gx * rot,
                     gy * gy, gy * rot, rot * rot,
                     fun * fun, ok.astype(jnp.float32)]).sum(axis=2)  # [11, B]
    d0, d1, d2, H00, H01, H02, H11, H12, H22 = red[:9]
    s0, s1, s2, solve_ok = _solve_scalar(H00, H01, H02, H11, H12, H22,
                                         d0, d1, d2, deriv_clamp, xy_clamp,
                                         damping)
    new_poses = jnp.stack([poses_px[:, 0] + s0, poses_px[:, 1] + s1,
                           poses_px[:, 2] + s2], axis=1)
    return new_poses, solve_ok, red[9], red[10]


def build_row_tables_batch(flat: jnp.ndarray, b: int,
                           cfg) -> Tuple[jnp.ndarray, ...]:
    """Fleet twin of build_row_tables: flat f32[B*cells] -> per-level
    f32[B, w_l, lanes_l] tables."""
    cells = sum(w * w for w in cfg.level_sizes)
    grids = flat.reshape(b, cells)
    parts = []
    for level in range(cfg.num_levels):
        w = cfg.level_sizes[level]
        off = cfg.level_offsets[level]
        g = grids[:, off:off + w * w].reshape(b, w, w)
        parts.append(jnp.pad(g, ((0, 0), (0, 0), (0, level_lanes(w) - w))))
    return tuple(parts)


def fused_gn_iteration_batch_onehot(table3d: jnp.ndarray, row_off: int,
                                    width: int, scale: float,
                                    poses_px: jnp.ndarray, X, Y, valid,
                                    deriv_clamp: float = 0.2,
                                    xy_clamp: float = 0.0,
                                    damping: float = 0.0,
                                    precision: str = "bf16"):
    """fused_gn_iteration_batch with the gather as batched one-hot matmuls.

    table3d: ONE level's build_row_tables_batch output f32[B, w_l, lanes_l]
    (row_off=0), or any [B, R, lanes] view — the fleet version of the
    single-instance one-hot form."""
    b = poses_px.shape[0]
    total_rows = table3d.shape[1]
    lanes = table3d.shape[2]
    sr = jnp.sin(poses_px[:, 2]) * scale
    cr = jnp.cos(poses_px[:, 2]) * scale
    mx = cr[:, None] * X - sr[:, None] * Y + poses_px[:, 0][:, None]
    my = sr[:, None] * X + cr[:, None] * Y + poses_px[:, 1][:, None]
    ok = valid & (mx >= 0.0) & (mx <= width - 2) & (my >= 0.0) \
        & (my <= width - 2)
    xi = jnp.clip(mx.astype(jnp.int32), 0, width - 2)
    yi = jnp.clip(my.astype(jnp.int32), 0, width - 2)

    # bf16 one-hot masks in the non-exact mode (see the single-instance
    # kernel: 0/1 exact in bf16, mask materialization is the cost)
    oh_dt = jnp.float32 if precision == "highest" else jnp.bfloat16
    ry = row_off + yi                                       # [B, N]
    rsel = jnp.concatenate([ry, ry + 1], axis=1)            # [B, 2N]
    iota_r = jnp.arange(total_rows, dtype=ry.dtype)
    oh_rows = (rsel[:, :, None] == iota_r).astype(oh_dt)    # [B, 2N, R]
    prec = (jax.lax.Precision.HIGHEST if precision == "highest" else None)
    tbl = table3d if precision == "highest" else table3d.astype(oh_dt)
    sel = jnp.einsum("bnr,brl->bnl", oh_rows, tbl,
                     precision=prec).astype(jnp.float32)    # [B, 2N, lanes]

    n = X.shape[1]
    lane = jnp.arange(lanes, dtype=xi.dtype)
    oh0 = (xi[:, :, None] == lane).astype(oh_dt)            # [B, N, lanes]
    oh1 = ((xi + 1)[:, :, None] == lane).astype(oh_dt)
    r0, r1 = sel[:, :n], sel[:, n:]
    v = jax.nn.sigmoid(jnp.stack([
        (r0 * oh0).sum(axis=2), (r0 * oh1).sum(axis=2),
        (r1 * oh0).sum(axis=2),
        (r1 * oh1).sum(axis=2)]).astype(jnp.float32))       # [4, B, N]

    fx = mx - xi
    fy = my - yi
    xf, yf = 1.0 - fx, 1.0 - fy
    val = (v[0] * xf + v[1] * fx) * yf + (v[2] * xf + v[3] * fx) * fy
    gx = -((v[0] - v[1]) * xf + (v[2] - v[3]) * fx)
    gy = -((v[0] - v[2]) * yf + (v[1] - v[3]) * fy)
    z = jnp.float32(0.0)
    gx = jnp.where(ok, gx, z)
    gy = jnp.where(ok, gy, z)
    fun = jnp.where(ok, 1.0 - val, z)
    rot = (-sr[:, None] * X - cr[:, None] * Y) * gx \
        + (cr[:, None] * X - sr[:, None] * Y) * gy
    red = jnp.stack([gx * fun, gy * fun, rot * fun,
                     gx * gx, gx * gy, gx * rot,
                     gy * gy, gy * rot, rot * rot,
                     fun * fun, ok.astype(jnp.float32)]).sum(axis=2)
    d0, d1, d2, H00, H01, H02, H11, H12, H22 = red[:9]
    s0, s1, s2, solve_ok = _solve_scalar(H00, H01, H02, H11, H12, H22,
                                         d0, d1, d2, deriv_clamp, xy_clamp,
                                         damping)
    new_poses = jnp.stack([poses_px[:, 0] + s0, poses_px[:, 1] + s1,
                           poses_px[:, 2] + s2], axis=1)
    return new_poses, solve_ok, red[9], red[10]
