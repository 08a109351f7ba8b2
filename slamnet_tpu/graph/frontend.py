"""Pose-graph frontend: keyframe selection, scan-to-scan matching, loop closures.

Constraints come from the same kernels as the Hector matcher: a keyframe's scan is
rasterized into a small local occupancy grid (ops.logodds) and another scan is
Gauss-Newton matched against it (ops.gn) — scan-to-scan relative poses without
any new kernel code.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from ..core.geometry import normalize_angle, pose_between
from ..core.scan import Scan
from ..ops import bilinear, gn, logodds, pallas_match


class ScanMatchConfig(NamedTuple):
    """Local grid + matcher settings for scan-to-scan constraints."""

    grid_size: int = 128        # local grid pixels
    resolution: float = 0.25    # m/px — local grid spans 32 m
    gn_iterations: int = 20
    log_odds_free: float = -0.40546511
    log_odds_occupied: float = 2.19722458
    inlier_prob: float = 0.6    # a query point "hits" if M(p) > this
    # production knobs (mirror HectorConfig; defaults keep the parity path):
    # "gather" | "onehot_highest" (bit-identical one-hot matmuls) |
    # "onehot_bf16" | "pallas" (whole match in one kernel, ops/pallas_match)
    matcher_mode: str = "gather"
    # scatter-free dense polar fill for the local grid (the loop-closure grid
    # build is a serialized ~B*len-cell scatter otherwise — the dominant cost
    # of a keyframe event, PERF.md)
    dense_fill: bool = False
    free_margin_px: float = 0.5
    # dense-fill free margin for the LOCAL grid.  Stays at the pre-round-5
    # value: the wall-erosion mechanism behind HectorConfig.
    # dense_free_margin_px needs REPEATED noisy updates of one map, and a
    # loop-closure grid is rasterized from a single scan — no erosion, and
    # the round-4 closure behavior (ATE 0.0067-0.0074 on the graph bench)
    # was measured with this margin.


class MatchQuality(NamedTuple):
    """Acceptance evidence for a scan-to-scan match.

    residual: mean (1 - M(p))^2 over in-bounds valid query points — near 0 for
    a locked match, ~0.25 when points fall on UNVISITED cells (sigmoid(0)=0.5),
    which is the perceptual-aliasing signature a gradient-based proxy misses.
    inlier_frac: fraction of valid query points landing on occupied map cells
    (M > inlier_prob) — the primary accept/reject signal.
    """

    residual: jnp.ndarray
    inlier_frac: jnp.ndarray


def rasterize_scan(scan: Scan, cfg: ScanMatchConfig) -> jnp.ndarray:
    """Build a local log-odds grid from one scan, robot at the grid center."""
    s = cfg.grid_size
    center = jnp.asarray([s // 2 * cfg.resolution, s // 2 * cfg.resolution, 0.0])
    grid = jnp.zeros((s * s,), jnp.float32)
    if cfg.dense_fill:
        import functools
        fill = functools.partial(logodds.update_occupancy_dense,
                                 free_margin_px=cfg.free_margin_px)
    else:
        fill = logodds.update_occupancy
    return fill(
        grid, s, scan.points, scan.valid, center, scan.pose[:2],
        1.0 / cfg.resolution, cfg.log_odds_free, cfg.log_odds_occupied)


def match_scans(scan_ref: Scan, scan_qry: Scan, init_rel,
                cfg: ScanMatchConfig) -> Tuple[jnp.ndarray, MatchQuality]:
    """Relative pose of scan_qry's robot in scan_ref's frame.

    Rasterizes scan_ref at the center of a local grid, then GN-matches scan_qry
    starting from `init_rel` (e.g. the odometry delta or the pose-graph guess).
    Returns (rel_pose f32[3], MatchQuality).

    The quality metrics are OCCUPANCY-based, not gradient-based: a match
    against an unrelated place converges with near-zero gradients (nothing to
    pull on), so |dTr| cannot reject aliasing; the fraction of query points
    actually landing on occupied cells can.
    """
    s = cfg.grid_size
    scale = 1.0 / cfg.resolution
    grid = rasterize_scan(scan_ref, cfg)
    center = jnp.asarray([s // 2 * cfg.resolution, s // 2 * cfg.resolution])

    init = jnp.asarray(init_rel, jnp.float32)
    pose_px = jnp.stack([(init[0] + center[0]) * scale,
                         (init[1] + center[1]) * scale, init[2]])
    if cfg.matcher_mode == "pallas":
        # the whole 20-iteration scan-to-scan match as one kernel
        # (ops/pallas_match.py): a single-level pyramid over the local grid
        level = pallas_match.Level(0, s, scale, cfg.gn_iterations)
        hint = jnp.stack([init[0] + center[0], init[1] + center[1], init[2]])
        out = pallas_match.match(grid, (level,), scan_qry.points[None, :, 0],
                                 scan_qry.points[None, :, 1],
                                 scan_qry.valid[None], hint[None])[0][0]
        pose_px = jnp.stack([out[0] * scale, out[1] * scale, out[2]])
    elif cfg.matcher_mode.startswith("onehot"):
        # the one-hot row fetch of the Hector matcher (ops/gn.py); a [s, s]
        # grid IS already a row table
        table2d = grid.reshape(s, s)
        prec = ("highest" if cfg.matcher_mode == "onehot_highest"
                else "default")
        for _ in range(cfg.gn_iterations):
            pose_px = gn.fused_gn_iteration_onehot_stats(
                table2d, 0, s, scale, pose_px, scan_qry.points[:, 0],
                scan_qry.points[:, 1], scan_qry.valid, precision=prec)[0]
    else:
        for _ in range(cfg.gn_iterations):
            pose_px = gn.fused_gn_iteration(grid, 0, s, scale, pose_px,
                                            scan_qry.points[:, 0],
                                            scan_qry.points[:, 1],
                                            scan_qry.valid)
    rel = jnp.stack([pose_px[0] / scale - center[0],
                     pose_px[1] / scale - center[1],
                     normalize_angle(pose_px[2])])

    # quality: bilinear map probability at every matched query point
    c, sn = jnp.cos(pose_px[2]) * scale, jnp.sin(pose_px[2]) * scale
    mx = c * scan_qry.points[:, 0] - sn * scan_qry.points[:, 1] + pose_px[0]
    my = sn * scan_qry.points[:, 0] + c * scan_qry.points[:, 1] + pose_px[1]
    val, _, _ = bilinear.interp_value_and_gradients(
        grid, s, jnp.stack([mx, my], axis=1), scan_qry.valid)
    in_b = (scan_qry.valid & (mx >= 0.0) & (mx <= s - 2) & (my >= 0.0)
            & (my <= s - 2))
    n_valid = jnp.maximum(jnp.sum(scan_qry.valid), 1)
    resid = jnp.sum(jnp.where(in_b, (1.0 - val) ** 2, 0.0)) \
        / jnp.maximum(jnp.sum(in_b), 1)
    inlier_frac = jnp.sum((val > cfg.inlier_prob) & in_b) / n_valid
    return rel, MatchQuality(residual=resid, inlier_frac=inlier_frac)


def keyframe_due(last_kf_pose, pose, dist_thresh: float,
                 angle_thresh: float) -> jnp.ndarray:
    """Spawn a new keyframe when moved far enough from the last one."""
    d = jnp.linalg.norm(pose[:2] - last_kf_pose[:2])
    a = jnp.abs(normalize_angle(pose[2] - last_kf_pose[2]))
    return (d > dist_thresh) | (a > angle_thresh)


def loop_candidates(poses: jnp.ndarray, node_valid: jnp.ndarray,
                    cur_idx, radius: float, min_index_gap: int) -> jnp.ndarray:
    """bool[K] mask of keyframes within `radius` of node `cur_idx` but at least
    `min_index_gap` older — loop-closure candidates by proximity."""
    cur = poses[cur_idx]
    d = jnp.linalg.norm(poses[:, :2] - cur[None, :2], axis=1)
    idx = jnp.arange(poses.shape[0])
    return node_valid & (d < radius) & (idx < cur_idx - min_index_gap)
