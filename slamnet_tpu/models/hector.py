"""HectorSLAM pipeline: multi-resolution pyramid + coarse-to-fine Gauss-Newton.

The array-program equivalent of HectorSLAMProcessor + MapRepMultiMap + ScanMatcher
(HectorSLAM/Main/*.cs, Matcher/ScanMatcher.cs): state is a pytree holding one
log-odds array per pyramid level; matching runs coarsest -> finest with statically
unrolled GN iterations (the per-level counts are config), all inside ONE jitted
step — the reference's per-scan thread fork/joins (ScanMatcher.cs:154,
MapRepMultiMap.cs:76) disappear into fused array ops.

Pyramid: level i+1 has half the pixels and twice the cell length of level i
(MapRepMultiMap.cs:49-57); every level is updated independently from the raw scan
(not downsampled).  Because level shapes are static, the Python loop over levels
unrolls at trace time and XLA schedules the (data-independent) per-level updates
concurrently — the reference's Parallel.ForEach task parallelism for free.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import HectorConfig
from ..core.geometry import deg_diff, normalize_angle, rad_diff
from ..core.scan import Scan
from ..ops import gn, logodds, pallas_match


class HectorState(NamedTuple):
    maps: jnp.ndarray               # f32[total_cells] — ALL levels concatenated,
                                    # finest first (cfg.level_offsets/level_sizes);
                                    # one flat table keeps the hot matcher loop a
                                    # single gather operand (no per-step concat)
    match_pose: jnp.ndarray         # f32[3] world
    last_update_pose: jnp.ndarray   # f32[3] world


class HectorInfo(NamedTuple):
    map_updated: jnp.ndarray        # bool
    # matcher health (ScanMatcher.cs:99-115 logs solve failures; surfaced here
    # as counters/values instead of log lines — SURVEY.md §5.5):
    # numpy (not jnp) defaults: a device scalar at class-definition time
    # would initialize the XLA backend at import, breaking
    # jax.distributed.initialize in multi-process runs
    residual: jnp.ndarray = np.float32(0.0)        # mean (1-M(p))^2 at final GN eval
    gn_iterations: jnp.ndarray = np.int32(0)       # GN iterations executed
    solve_failures: jnp.ndarray = np.int32(0)      # iterations with singular H


class MatchStats(NamedTuple):
    residual: jnp.ndarray        # f32 mean squared occupancy residual, finest level
    iterations: jnp.ndarray      # i32 total GN iterations executed (all levels)
    solve_failures: jnp.ndarray  # i32 iterations where the 3x3 solve failed
    in_map_frac: jnp.ndarray     # f32 in-bounds fraction of valid matcher beams
    #                              (last GN iteration, finest level) — the
    #                              match-evidence signal behind the
    #                              min_match_in_map_frac guard


def init(cfg: HectorConfig, start_pose) -> HectorState:
    """Ctor/Reset semantics (HectorSLAMProcessor.cs:66-77, 131-138): zeroed maps,
    match pose at start, last-update pose at float.MinValue so the first scan
    always updates the maps (the squared distance overflows to +inf in f32)."""
    return HectorState(
        maps=jnp.zeros((cfg.total_cells,), jnp.float32),
        match_pose=jnp.asarray(start_pose, jnp.float32),
        last_update_pose=jnp.full(3, -3.4028235e38, jnp.float32),
    )


def level_view(maps: jnp.ndarray, cfg: HectorConfig, level: int) -> jnp.ndarray:
    """The [S, S] log-odds grid of one pyramid level (copy-on-read view)."""
    off = cfg.level_offsets[level]
    s = cfg.level_sizes[level]
    return maps[off:off + s * s].reshape(s, s)


def map_extents(maps: jnp.ndarray, cfg: HectorConfig, level: int = 0):
    """Bounding box of touched (non-default) cells at one level:
    (found bool, x_min, y_min, x_max, y_max) — GridMap.GetMapExtends
    (GridMap.cs:147-207), vectorized."""
    grid = level_view(maps, cfg, level)
    touched = grid != 0.0
    any_t = jnp.any(touched)
    s = grid.shape[0]
    cols = jnp.any(touched, axis=0)
    rows = jnp.any(touched, axis=1)
    idx = jnp.arange(s)
    big = jnp.int32(s)
    x_min = jnp.min(jnp.where(cols, idx, big))
    y_min = jnp.min(jnp.where(rows, idx, big))
    x_max = jnp.max(jnp.where(cols, idx, -1))
    y_max = jnp.max(jnp.where(rows, idx, -1))
    z = jnp.int32(0)
    return (any_t,
            jnp.where(any_t, x_min, z), jnp.where(any_t, y_min, z),
            jnp.where(any_t, x_max, z), jnp.where(any_t, y_max, z))


def world_to_map(pose_world: jnp.ndarray, scale_to_map: float,
                 offset) -> jnp.ndarray:
    """GetMapCoordsPose (GridMap.cs:122-137): p_map = p * scale + offset.

    (The reference composes Scale(s) * Translate(offset) in row-vector convention,
    so the offset is applied after scaling; MapRepMultiMap always passes zero.)
    """
    return jnp.stack([pose_world[0] * scale_to_map + offset[0],
                      pose_world[1] * scale_to_map + offset[1],
                      pose_world[2]])


def map_to_world(pose_map: jnp.ndarray, scale_to_map: float,
                 offset) -> jnp.ndarray:
    return jnp.stack([(pose_map[0] - offset[0]) / scale_to_map,
                      (pose_map[1] - offset[1]) / scale_to_map,
                      pose_map[2]])


def _pad_beams(x, pad_to: int, fill=0.0):
    n = x.shape[0]
    if n >= pad_to:
        return x
    pad_shape = (pad_to - n,) + x.shape[1:]
    return jnp.concatenate([x, jnp.full(pad_shape, fill, x.dtype)])


def _lane_pad(n: int) -> int:
    """Pad the beam axis to a multiple of 128 (the XLA matchers' shapes; the
    matcher kernel pads further, to a power of two)."""
    return max(128, -(-n // 128) * 128)


def match(state_maps: jnp.ndarray, scan: Scan,
          hint_pose_world: jnp.ndarray, cfg: HectorConfig) -> jnp.ndarray:
    """ScanMatcher.MatchData over the pyramid (ScanMatcher.cs:41-84): start at the
    coarsest level, per level run EstimateIterations GN steps in map coords,
    normalize heading, feed the estimate to the next-finer level.

    Hot path: one concatenated flat table, padded beam axis, fused GN
    iterations (ops/gn.fused_gn_iteration), or the whole match as one kernel
    (matcher_mode="pallas", ops/pallas_match.py).
    """
    return match_with_stats(state_maps, scan, hint_pose_world, cfg)[0]


def match_with_stats(state_maps: jnp.ndarray, scan: Scan,
                     hint_pose_world: jnp.ndarray,
                     cfg: HectorConfig) -> Tuple[jnp.ndarray, MatchStats]:
    """match + matcher health (residual / iteration count / solve failures —
    the reference surfaces these as ILogger lines, ScanMatcher.cs:99-115)."""
    table = state_maps
    offsets = cfg.level_offsets

    pts = scan.points
    vld = scan.valid
    if cfg.match_subsample > 1:
        # matcher-only beam subsampling (map updates keep every beam)
        pts = pts[::cfg.match_subsample]
        vld = vld[::cfg.match_subsample]
    pad = _lane_pad(pts.shape[0])
    X = _pad_beams(pts[:, 0], pad)
    Y = _pad_beams(pts[:, 1], pad)
    valid = _pad_beams(vld, pad, fill=False)

    any_valid = jnp.any(scan.valid)
    if cfg.matcher_mode == "pallas":
        # the whole coarse-to-fine match as ONE kernel (ops/pallas_match.py;
        # the gather matcher's semantics, fixed per-level iterations)
        poses, fails, resid_sum, n_in = pallas_match.match(
            table, pallas_match.levels_of(cfg), X[None], Y[None], valid[None],
            hint_pose_world[None], **pallas_match.solver_args(cfg))
        pose = jnp.where(any_valid, poses[0], hint_pose_world)
        stats = MatchStats(
            residual=resid_sum[0] / jnp.maximum(n_in[0], 1.0),
            iterations=jnp.int32(sum(cfg.estimate_iterations[:cfg.num_levels])),
            solve_failures=fails[0],
            in_map_frac=n_in[0] / jnp.maximum(
                jnp.sum(valid.astype(jnp.float32)), 1.0))
        return pose, stats

    estimate = hint_pose_world
    ox, oy = cfg.offset
    iters = jnp.int32(0)
    fails = jnp.int32(0)
    resid_sum = jnp.float32(0.0)
    n_in = jnp.float32(0.0)
    onehot = cfg.matcher_mode.startswith("onehot")
    if onehot:
        # per-level padded views, built once per match; GN iterations then
        # fetch rows by one-hot matmuls (ops/gn.py) — each level pays only
        # its own [w_l, lanes_l] matmul
        tables = gn.build_row_tables(table, cfg)
        prec = "highest" if cfg.matcher_mode == "onehot_highest" else "bf16"
    for level in range(cfg.num_levels - 1, -1, -1):
        width = cfg.level_sizes[level]
        scale = 1.0 / cfg.level_resolutions[level]
        est_px = jnp.stack([estimate[0] * scale + ox, estimate[1] * scale + oy,
                            estimate[2]])
        n_iters = cfg.estimate_iterations[level]

        if onehot:
            def one_iter(p, level=level):
                return gn.fused_gn_iteration_onehot_stats(
                    tables[level], 0, width, scale, p, X, Y, valid,
                    cfg.deriv_clamp, cfg.xy_step_clamp_px, cfg.gn_damping,
                    precision=prec)
        else:
            def one_iter(p, level=level):
                return gn.fused_gn_iteration_stats(
                    table, offsets[level], width, scale, p, X, Y, valid,
                    cfg.deriv_clamp, cfg.xy_step_clamp_px, cfg.gn_damping)

        if cfg.early_exit_tol > 0.0:
            # converged early-exit: extra fixed iterations are numeric no-ops
            tol2 = cfg.early_exit_tol ** 2

            def cond(carry):
                i, p, moved2, f, rs, ni = carry
                return (i < n_iters) & (moved2 > tol2)

            def body(carry):
                i, p, _, f, rs, ni = carry
                p2, ok, rs2, ni2 = one_iter(p)
                return (i + 1, p2, jnp.sum((p2 - p) ** 2),
                        f + (~ok).astype(jnp.int32), rs2, ni2)

            li, est_px, _, fails, resid_sum, n_in = jax.lax.while_loop(
                cond, body, (jnp.int32(0), est_px, jnp.float32(jnp.inf),
                             fails, resid_sum, n_in))
            iters = iters + li
        else:
            for _ in range(n_iters):
                est_px, ok, resid_sum, n_in = one_iter(est_px)
                fails = fails + (~ok).astype(jnp.int32)
            iters = iters + n_iters
        th = normalize_angle(est_px[2])
        estimate = jnp.stack([(est_px[0] - ox) / scale, (est_px[1] - oy) / scale,
                              th])
    # empty scan returns the hint (ScanMatcher.cs:82-83)
    pose = jnp.where(any_valid, estimate, hint_pose_world)
    stats = MatchStats(residual=resid_sum / jnp.maximum(n_in, 1.0),
                       iterations=iters, solve_failures=fails,
                       in_map_frac=n_in / jnp.maximum(
                           jnp.sum(valid.astype(jnp.float32)), 1.0))
    return pose, stats


def update_maps(state_maps: jnp.ndarray, scan: Scan,
                pose_world: jnp.ndarray, cfg: HectorConfig) -> jnp.ndarray:
    """MapRepMultiMap.UpdateByScan (MapRepMultiMap.cs:73-77): every level updated
    independently from the raw scan.  The static per-level slices unroll at trace
    time; XLA schedules the data-independent level updates concurrently (the
    reference's Parallel.ForEach for free)."""
    if cfg.dense_free_fill:
        import functools
        fn = functools.partial(logodds.update_occupancy_dense,
                               free_margin_px=cfg.dense_free_margin_px)
    else:
        fn = logodds.update_occupancy
    out = []
    for level in range(cfg.num_levels):
        width = cfg.level_sizes[level]
        off = cfg.level_offsets[level]
        scale = 1.0 / cfg.level_resolutions[level]
        out.append(fn(
            state_maps[off:off + width * width], width, scan.points, scan.valid,
            pose_world, scan.pose[:2], scale, cfg.log_odds_free,
            cfg.log_odds_occupied, cfg.occupied_cap))
    return jnp.concatenate(out)


def update(state: HectorState, scan: Scan, pose_hint_world,
           cfg: HectorConfig,
           map_without_matching=False) -> Tuple[HectorState, HectorInfo]:
    """HectorSLAMProcessor.Update (HectorSLAMProcessor.cs:86-126): match (unless
    bootstrapping), then update the maps only if moved beyond the distance/angle
    thresholds or when mapping is forced."""
    pose_hint_world = jnp.asarray(pose_hint_world, jnp.float32)
    force = jnp.asarray(map_without_matching)

    matched, mstats = match_with_stats(state.maps, scan, pose_hint_world, cfg)
    if cfg.min_match_in_map_frac > 0.0:
        # production robustness (worlds larger than the map): a match
        # resting on too few in-map beams is a one-sided degenerate solve —
        # reject it, keep the odometry hint (core/config.py docstring)
        matched = jnp.where(mstats.in_map_frac >= cfg.min_match_in_map_frac,
                            matched, pose_hint_world)
    if cfg.max_match_jump > 0.0:
        # production robustness: a physically-impossible per-scan jump is a
        # degenerate-view solve — reject the match, keep the hint
        jump2 = jnp.sum((matched[:2] - pose_hint_world[:2]) ** 2)
        matched = jnp.where(jump2 <= cfg.max_match_jump ** 2, matched,
                            pose_hint_world)
    match_pose = jnp.where(force, pose_hint_world, matched)

    dist2 = jnp.sum((match_pose[:2] - state.last_update_pose[:2]) ** 2)
    if cfg.angle_gate_compat:
        # reference quirk: DegDiff (degrees formula) on radian values, SIGNED
        # compare (HectorSLAMProcessor.cs:108) — negative rotations never trigger
        ang_gate = deg_diff(match_pose[2], state.last_update_pose[2]) \
            > cfg.min_angle_diff_for_map_update
    else:
        ang_gate = jnp.abs(rad_diff(match_pose[2], state.last_update_pose[2])) \
            > cfg.min_angle_diff_for_map_update
    do_update = (dist2 > cfg.min_distance_diff_for_map_update ** 2) | ang_gate | force

    def with_update(maps):
        return update_maps(maps, scan, match_pose, cfg)

    new_maps = jax.lax.cond(do_update, with_update, lambda m: m, state.maps)
    new_last = jnp.where(do_update, match_pose, state.last_update_pose)

    return (HectorState(new_maps, match_pose, new_last),
            HectorInfo(map_updated=do_update, residual=mstats.residual,
                       gn_iterations=mstats.iterations,
                       solve_failures=mstats.solve_failures))
