"""Sharded full-pipeline CoreSLAM — hole map tiled, candidates data-parallel.

The CoreSLAM counterpart of models/hector_sharded (VERDICT round-1 missing #2:
"the hole/obstacle maps have no sharded form"): the ENTIRE per-scan step runs
as ONE shard_map'd SPMD program over a ('tile' x 'search') mesh:

  * the hole map is ROW-TILED over 'tile'.  Scoring gathers single cells (no
    bilinear neighbors), so tiles need NO halo at all; each device scores the
    points that land in its rows and the per-candidate pixel sums psum over
    'tile' — integer adds, so sharded scores are BIT-EXACT vs the dense kernel;
  * search_mode="mc": the Monte-Carlo candidate batch is sharded over 'search'
    (the reference's thread-per-stream search, CoreSLAMProcessor.cs:674-710,
    as a mesh axis).  Candidates are sampled REPLICATED from the same key as
    the dense pipeline and sliced per shard, so the global argmin
    (lexicographic min over (score, candidate index) across devices) picks the
    IDENTICAL winner — bit-exact vs models/coreslam
    (tests/test_coreslam_sharded.py);
  * search_mode="correlative" (the PRODUCTION mode, ops/correlate.py): theta
    bins shard over 'search' and the count-grid x shifted-map-plane matmul
    contraction shards over 'tile' — each tile contracts its cnt row band
    against shift-planes built from ITS OWN map rows only (non-owned rows
    zero), so the psum over 'tile' reassembles the full integer-exact hi/lo
    plane sums with NO halo exchange; the tiny [K, W, W] effective-score grid
    all-gathers over 'search' and the sub-pixel refinement runs replicated —
    bit-exact winner vs ops/correlate.correlative_search (see
    _correlative_scores_local);
  * hole-map updates: the line mode's per-cell composition (visits count +
    visit-mean value, ops/holemap.py) is ADDITIVE over beams: each device
    rasterizes its beam shard, accumulates (visits, vsum) for its rows, psums
    over 'search', and blends element-wise — bit-exact, no ordering concerns.
    The dense polar fill (dense_hole_fill=True) is elementwise per cell given
    the replicated [angle_bins] range table, so each tile fills its own rows
    — bitwise equal to ops/holemap.update_hole_map_dense on the same rows;
  * the obstacle map is 64x64 (SimConfig) — far below a useful tiling grain;
    it stays replicated and every device computes the identical update
    (zero communication, documented trade) in either line or dense mode.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import CoreSlamConfig
from ..core.geometry import csharp_trunc, normalize_angle
from ..ops import correlate as correlate_ops
from ..ops import holemap as holemap_ops
from ..ops import obstacle as obstacle_ops
from ..ops import score as score_ops
from ..ops.holemap import TS_NO_OBSTACLE, TS_OBSTACLE
from ..ops.rasterize import hole_ray_cells
from . import coreslam


class ShardedCoreSlamState(NamedTuple):
    local_hole: jnp.ndarray     # i32[T, rows*S] row-tiled hole map (no halo)
    obstacle_map: jnp.ndarray   # i8[OS, OS] replicated
    pose: jnp.ndarray           # f32[3]
    last_odometry: jnp.ndarray  # f32[3]
    scan_count: jnp.ndarray     # i32[]
    key: jnp.ndarray            # PRNG key


def shard_state(mesh: Mesh, dense: coreslam.CoreSlamState,
                cfg: CoreSlamConfig,
                tile_axis: str = "tile") -> ShardedCoreSlamState:
    n_tiles = mesh.shape[tile_axis]
    s = cfg.hole_map_size
    assert s % n_tiles == 0, (s, n_tiles)
    rows = s // n_tiles
    tiles = jnp.stack([dense.hole_map[t * rows * s:(t + 1) * rows * s]
                       for t in range(n_tiles)])
    rep = NamedSharding(mesh, P())
    return ShardedCoreSlamState(
        local_hole=jax.device_put(tiles, NamedSharding(mesh, P(tile_axis))),
        obstacle_map=jax.device_put(dense.obstacle_map, rep),
        pose=jax.device_put(dense.pose, rep),
        last_odometry=jax.device_put(dense.last_odometry, rep),
        scan_count=jax.device_put(dense.scan_count, rep),
        key=jax.device_put(dense.key, rep))


def init(mesh: Mesh, cfg: CoreSlamConfig, start_pose, key=None,
         tile_axis: str = "tile") -> ShardedCoreSlamState:
    return shard_state(mesh, coreslam.init(cfg, start_pose, key=key), cfg,
                       tile_axis)


def to_dense(state: ShardedCoreSlamState) -> coreslam.CoreSlamState:
    return coreslam.CoreSlamState(
        hole_map=state.local_hole.reshape(-1),
        obstacle_map=state.obstacle_map, pose=state.pose,
        last_odometry=state.last_odometry, scan_count=state.scan_count,
        key=state.key)


def _correlative_scores_local(local_hole, size, rows_m, tile, srank, scale,
                              points, valid, search_pose, thetas, window,
                              kloc, tile_axis):
    """This shard's slice of the correlative effective-score grid.

    Sharded twin of ops/correlate.correlative_scores: theta bins [srank*kloc,
    (srank+1)*kloc) of the K bins; the cnt x shifted-plane contraction runs
    over THIS TILE'S cnt row band against planes holding only its owned map
    rows (everything else zero), psum'd over `tile_axis`.  Each (cnt-row,
    map-row) product appears on exactly one tile (owned rows partition the
    map), and the hi/lo/mask plane partial sums stay < 2^24, so the psum'd f32
    sums — and the combined integer scores — are BIT-EXACT vs the dense kernel.

    Returns eff i32[kloc, W, W] (int-max where no point lands in bounds).
    """
    from ..ops.correlate import INT32_MAX as CINT32_MAX

    R = window // 2
    spad = size + 2 * R
    m0 = tile * rows_m
    band_h = rows_m + window - 1
    start = 2 * R - window + 1          # tile-relative: band rows are
    #                                     [m0 + start, m0 + start + band_h)

    px = search_pose[0] * scale + 0.5
    py = search_pose[1] * scale + 0.5
    th = jax.lax.dynamic_slice_in_dim(thetas, srank * kloc, kloc, 0)
    c = (jnp.cos(th) * scale)[:, None]
    s = (jnp.sin(th) * scale)[:, None]
    X = points[:, 0][None, :]
    Y = points[:, 1][None, :]
    xb = csharp_trunc(px + c * X - s * Y)          # [kloc, N]
    yb = csharp_trunc(py + s * X + c * Y)

    ok = (valid[None, :] & (xb >= -R) & (xb < size + R)
          & (yb >= -R) & (yb < size + R))
    band_ids = (m0 + start) + jnp.arange(band_h, dtype=xb.dtype)
    grid_ids = jnp.arange(spad, dtype=xb.dtype)
    oh_y = ((yb + R)[:, :, None] == band_ids).astype(jnp.float32) \
        * ok[:, :, None].astype(jnp.float32)                # [kloc, N, band_h]
    oh_x = ((xb + R)[:, :, None] == grid_ids).astype(jnp.float32)
    cnt = jnp.einsum("knb,knt->kbt", oh_y, oh_x,
                     preferred_element_type=jnp.float32).reshape(
        kloc, band_h * spad)

    # separable in-bounds counts (the round-5 dense-kernel restructuring,
    # ops/correlate.correlative_scores): a box condition per point, complete
    # LOCALLY from this shard's theta bins — no map planes, no psum
    dshift = jnp.arange(window, dtype=xb.dtype) - R
    rowok = (ok[:, :, None] & ((yb[:, :, None] + dshift) >= 0)
             & ((yb[:, :, None] + dshift) < size)).astype(jnp.float32)
    colok = (((xb[:, :, None] + dshift) >= 0)
             & ((xb[:, :, None] + dshift) < size)).astype(jnp.float32)
    nb = jnp.einsum("knw,knv->kwv", rowok, colok,
                    preferred_element_type=jnp.float32).astype(
        jnp.int32).reshape(kloc, window * window)

    # shift planes from THIS tile's owned rows only (q rows [m0+2R,
    # m0+rows_m+2R) = plane rows [window-1, window-1+rows_m))
    qh = jnp.zeros((band_h + window - 1, size + 4 * R), jnp.int32)
    qh = jax.lax.dynamic_update_slice(qh, local_hole.reshape(rows_m, size),
                                      (window - 1, 2 * R))
    shifts = []
    for dy in range(window):
        for dx in range(window):
            shifts.append(qh[dy:dy + band_h, dx:dx + spad].reshape(-1))
    hs = jnp.stack(shifts)                          # i32 [W*W, band_h*spad]

    w2 = window * window
    big = jnp.concatenate([(hs >> 8).astype(jnp.float32),
                           (hs & 0xFF).astype(jnp.float32)],
                          axis=0)                   # [2*W*W, band_h*spad]
    out = jnp.dot(cnt, big.T, preferred_element_type=jnp.float32)
    out = jax.lax.psum(out, tile_axis)              # exact: plane sums < 2^24
    sums = (256.0 * out[:, :w2] + out[:, w2:2 * w2]).astype(jnp.int32)
    eff = jnp.where(nb > 0, sums, CINT32_MAX)
    return eff.reshape(kloc, window, window)


def _dense_hole_fill_local(local_hole, size, rows_m, r0, scale, points, valid,
                           pose, hole_width, quality, angle_bins):
    """This tile's rows of ops/holemap.update_hole_map_dense — identical
    per-cell math (the polar range table is replicated B-point work; the cell
    pass is elementwise), so the result is bitwise equal row-for-row."""
    px = pose[0] * scale + 0.5
    py = pose[1] * scale + 0.5
    c = jnp.cos(pose[2]) * scale
    s = jnp.sin(pose[2]) * scale
    x1 = csharp_trunc(px)
    y1 = csharp_trunc(py)
    robot_in = (x1 >= 0) & (x1 < size) & (y1 >= 0) & (y1 < size)

    x2p = c * points[:, 0] - s * points[:, 1]
    y2p = s * points[:, 0] + c * points[:, 1]
    dist = jnp.sqrt(x2p * x2p + y2p * y2p)
    beam_ok = valid & (dist > 1e-6)
    hw2 = hole_width * scale / 2.0

    ang = jnp.arctan2(y2p, x2p)
    bins = jnp.clip(((ang + jnp.pi) * (angle_bins / (2.0 * jnp.pi)))
                    .astype(jnp.int32), 0, angle_bins - 1)
    big = jnp.float32(1e9)
    table = jnp.full(angle_bins, big, jnp.float32).at[
        jnp.where(beam_ok, bins, 0)].min(jnp.where(beam_ok, dist, big))
    table = jnp.where(table < big, table, -big)

    yy = jax.lax.broadcasted_iota(jnp.int32, (rows_m, size), 0) + r0
    xx = jax.lax.broadcasted_iota(jnp.int32, (rows_m, size), 1)
    dx = xx.astype(jnp.float32) + 0.5 - px
    dy = yy.astype(jnp.float32) + 0.5 - py
    r_c = jnp.sqrt(dx * dx + dy * dy)
    cbin = jnp.clip(((jnp.arctan2(dy, dx) + jnp.pi)
                     * (angle_bins / (2.0 * jnp.pi))).astype(jnp.int32),
                    0, angle_bins - 1)
    r_m = holemap_ops.polar_lookup(table, cbin)
    covered = r_c < r_m + hw2
    ramp = jnp.clip(1.0 - jnp.abs(r_c - r_m) / jnp.maximum(hw2, 1e-6),
                    0.0, 1.0)
    v = TS_NO_OBSTACLE + (TS_OBSTACLE - TS_NO_OBSTACLE) * ramp

    old = local_hole.reshape(rows_m, size)
    blended = ((256 - quality) * old + quality * v.astype(jnp.int32)) // 256
    new = jnp.where(covered, blended, old).reshape(-1)
    return jnp.where(robot_in, new, local_hole)


def make_step(mesh: Mesh, cfg: CoreSlamConfig, tile_axis: str = "tile",
              search_axis: str = "search"):
    """Build the jitted sharded per-scan step:
    step(state, points f32[N,2], valid bool[N], odometry_pose f32[3])
      -> (state, CoreSlamInfo) — same contract as coreslam.update_cloud,
    for BOTH search modes (mc parity / correlative production) and both fill
    modes (line parity / dense polar)."""
    n_tiles = mesh.shape[tile_axis]
    n_search = mesh.shape[search_axis]
    size = cfg.hole_map_size
    assert size % n_tiles == 0
    rows = size // n_tiles
    if cfg.search_mode == "mc":
        assert cfg.num_candidates % n_search == 0
        local_b = cfg.num_candidates // n_search
    else:
        assert cfg.search_mode == "correlative", cfg.search_mode
        assert cfg.corr_num_theta % n_search == 0, (cfg.corr_num_theta,
                                                    n_search)
        kloc = cfg.corr_num_theta // n_search
        corr_span = cfg.corr_theta_span or 3.0 * cfg.sigma_theta

    def _check_beams(n):
        assert n % n_search == 0, (n, n_search)

    def local_step(local_hole, obst, pose, last_odo, scan_count, key,
                   points, valid, odo):
        local_hole = local_hole[0]          # [rows*S]
        tile = jax.lax.axis_index(tile_axis)
        srank = jax.lax.axis_index(search_axis)
        r0 = tile * rows

        key, sub = jax.random.split(key)
        search_pose = pose + (odo - last_odo)
        warm = scan_count >= cfg.position_search_beginning

        if cfg.search_mode == "mc":
            # ---- MC search: replicated sampling, tiled+sharded scoring -----
            kxy, kth = jax.random.split(sub)
            dxy = jax.random.normal(kxy,
                                    (cfg.num_candidates, 2)) * cfg.sigma_xy
            dth = jax.random.normal(kth,
                                    (cfg.num_candidates, 1)) * cfg.sigma_theta
            deltas = jnp.concatenate([dxy, dth], axis=1).at[0].set(0.0)
            cands_all = search_pose[None, :] + deltas
            cands = jax.lax.dynamic_slice_in_dim(cands_all, srank * local_b,
                                                 local_b, axis=0)

            # per-candidate sums restricted to my rows, psum'd over 'tile' —
            # integer adds, bit-exact vs ops.score.score_candidates on the
            # reassembled map (CalculateDistanceSISD semantics, :226-259)
            px = cands[:, 0] * cfg.hole_scale + 0.5
            py = cands[:, 1] * cfg.hole_scale + 0.5
            c = jnp.cos(cands[:, 2]) * cfg.hole_scale
            sn = jnp.sin(cands[:, 2]) * cfg.hole_scale
            X = points[:, 0][None, :]
            Y = points[:, 1][None, :]
            x = csharp_trunc(px[:, None] + c[:, None] * X - sn[:, None] * Y)
            y = csharp_trunc(py[:, None] + sn[:, None] * X + c[:, None] * Y)
            in_b = ((x >= 0) & (x < size) & (y >= 0) & (y < size)
                    & valid[None, :])
            mine = in_b & (y >= r0) & (y < r0 + rows)
            flat = jnp.where(mine, (y - r0) * size + x, 0)
            vals = jnp.where(mine, jnp.take(local_hole, flat), 0)
            sums = jax.lax.psum(vals.sum(axis=1, dtype=jnp.int32), tile_axis)
            nb = jax.lax.psum(mine.sum(axis=1, dtype=jnp.int32), tile_axis)

            eff = jnp.where(nb > 0, sums, score_ops.INT32_MAX)
            li = jnp.argmin(eff)
            # lexicographic global argmin over 'search': (score, global
            # index) — identical tie-breaking to the dense single argmin
            # (shards hold contiguous candidate slices, so the lowest winning
            # global index IS the dense argmin's first minimum)
            gidx = (srank * local_b + li).astype(jnp.int32)
            best_sum = jax.lax.pmin(eff[li], search_axis)
            best_idx = jax.lax.pmin(
                jnp.where(eff[li] == best_sum, gidx, score_ops.INT32_MAX),
                search_axis)
            best_pose = cands_all[best_idx]
        else:
            # ---- correlative search: theta over 'search', contraction over
            # 'tile' (see _correlative_scores_local) -------------------------
            thetas = search_pose[2] + jnp.linspace(-corr_span, corr_span,
                                                   cfg.corr_num_theta)
            eff_loc = _correlative_scores_local(
                local_hole, size, rows, tile, srank, cfg.hole_scale, points,
                valid, search_pose, thetas, cfg.corr_window, kloc, tile_axis)
            eff = jax.lax.all_gather(eff_loc, search_axis,
                                     tiled=True)          # [K, W, W], tiny
            best_pose, best_sum = correlate_ops.refine_from_scores(
                eff, search_pose, cfg.hole_scale, cfg.corr_window,
                cfg.corr_num_theta, corr_span)

        new_pose = jnp.where(warm, best_pose, odo)
        new_pose = new_pose.at[2].set(normalize_angle(new_pose[2]))
        best_sum = jnp.where(warm, best_sum, 0)

        if cfg.dense_hole_fill:
            # ---- dense polar fill: elementwise on owned rows ----------------
            new_hole = _dense_hole_fill_local(
                local_hole, size, rows, r0, cfg.hole_scale, points, valid,
                new_pose, cfg.hole_width, cfg.quality, cfg.angle_bins)
        else:
            # ---- line mode: beam-sharded additive (visits, vsum) ------------
            hpx = new_pose[0] * cfg.hole_scale + 0.5
            hpy = new_pose[1] * cfg.hole_scale + 0.5
            hc = jnp.cos(new_pose[2]) * cfg.hole_scale
            hs = jnp.sin(new_pose[2]) * cfg.hole_scale
            x1 = csharp_trunc(hpx)
            y1 = csharp_trunc(hpy)
            robot_in = (x1 >= 0) & (x1 < size) & (y1 >= 0) & (y1 < size)
            x1c = jnp.clip(x1, 0, size - 1)
            y1c = jnp.clip(y1, 0, size - 1)

            n = points.shape[0]
            nloc = n // n_search
            pts_s = jax.lax.dynamic_slice_in_dim(points, srank * nloc, nloc, 0)
            val_s = jax.lax.dynamic_slice_in_dim(valid, srank * nloc, nloc, 0)
            x2p = hc * pts_s[:, 0] - hs * pts_s[:, 1]
            y2p = hs * pts_s[:, 0] + hc * pts_s[:, 1]
            xp = csharp_trunc(hpx + x2p)
            yp = csharp_trunc(hpy + y2p)
            dist = jnp.sqrt(x2p * x2p + y2p * y2p)
            beam_ok = val_s & (dist > 1e-6)
            add = cfg.hole_width * cfg.hole_scale / 2.0 \
                / jnp.maximum(dist, 1e-6)
            x2 = csharp_trunc(hpx + x2p * (1.0 + add))
            y2 = csharp_trunc(hpy + y2p * (1.0 + add))

            rays = hole_ray_cells(x1c, y1c, x2, y2, xp, yp, TS_OBSTACLE,
                                  TS_NO_OBSTACLE, size, max_steps=size)
            cy = rays.flat // size
            cx = rays.flat - cy * size
            mask = rays.mask & beam_ok[:, None] & (cy >= r0) & (cy < r0 + rows)
            lflat = jnp.where(mask, (cy - r0) * size + cx, 0)
            ncl = rows * size
            visits = jnp.zeros(ncl, jnp.int32).at[lflat.reshape(-1)].add(
                mask.reshape(-1).astype(jnp.int32))
            vsum = jnp.zeros(ncl, jnp.int32).at[lflat.reshape(-1)].add(
                jnp.where(mask, rays.pixval, 0).reshape(-1))
            visits = jax.lax.psum(visits, search_axis)
            vsum = jax.lax.psum(vsum, search_axis)

            vbar = vsum.astype(jnp.float32) / jnp.maximum(visits, 1)
            beta = (256.0 - cfg.quality) / 256.0
            decay = jnp.power(beta, visits.astype(jnp.float32))
            old = local_hole.astype(jnp.float32)
            blended = jnp.floor(decay * (old - vbar) + vbar).astype(jnp.int32)
            new_hole = jnp.where(visits > 0, blended, local_hole)
            new_hole = jnp.where(robot_in, new_hole, local_hole)

        # ---- obstacle map: tiny (64^2) — replicated identical update --------
        if cfg.dense_obstacle_fill:
            new_obst = obstacle_ops.update_obstacle_map_dense(
                obst, cfg.obstacle_map_size, cfg.obstacle_scale, points,
                valid, new_pose, cfg.max_obstacle_hits, cfg.angle_bins)
        else:
            new_obst = obstacle_ops.update_obstacle_map(
                obst, cfg.obstacle_map_size, cfg.obstacle_scale, points,
                valid, new_pose, cfg.max_obstacle_hits)

        new_count = jnp.where(warm, scan_count, scan_count + 1)
        info = coreslam.CoreSlamInfo(searched=warm, best_sum=best_sum)
        return (new_hole[None], new_obst, new_pose, odo, new_count, key, info)

    sharded = shard_map(
        local_step, mesh=mesh,
        in_specs=(P(tile_axis), P(), P(), P(), P(), P(), P(), P(), P()),
        out_specs=(P(tile_axis), P(), P(), P(), P(), P(), P()),
        check_vma=False)

    @jax.jit
    def step(state: ShardedCoreSlamState, points, valid, odometry_pose):
        _check_beams(points.shape[0])
        (hole, obst, pose, odo, count, key, info) = sharded(
            state.local_hole, state.obstacle_map, state.pose,
            state.last_odometry, state.scan_count, state.key,
            points, valid, jnp.asarray(odometry_pose, jnp.float32))
        return ShardedCoreSlamState(hole, obst, pose, odo, count, key), info

    return step
