"""Sharded full-pipeline HectorSLAM — the bench-scale multi-device mode.

The end-to-end composition of the parallel building blocks (SURVEY.md §5.7/§5.8,
BASELINE.md scaling target): the ENTIRE per-scan step — coarse-to-fine
Gauss-Newton matching over the multi-resolution pyramid + the motion-gated
log-odds occupancy update — runs as ONE shard_map'd SPMD program over a
('tile' x 'search') device mesh:

  * every pyramid level is ROW-TILED over 'tile' (grid memory sharded; tp).
    Row-tiling every level (instead of placing levels on devices) keeps all
    devices busy at every level, scales past num_levels devices, and needs only
    a 1-row halo per level (bilinear reads y+1, ScanMatcher.cs:230-233);
  * the beam axis is sharded over 'search' (sequence parallelism; sp): each
    device accumulates (H, dTr) partials from its beam shard landing in its
    rows, psum'd over BOTH axes per GN iteration (the reference's per-thread
    chunk + host sum, ScanMatcher.cs:149-196, as one collective);
  * map updates: each device rasterizes its beam shard, marks its rows; the
    free/occupied masks OR-combine over 'search' (pmax) and the log-odds apply
    is element-wise on owned rows, followed by a 1-row ppermute halo refresh
    per level — the ring-exchange pattern for grids.

Per-tile memory layout: ONE flat local table (the sharded analogue of
HectorState.maps — one gather operand for the hot loop, PERF.md): for each
level, rows_l*W owned cells then W halo cells.  Appending the halo row directly
after the owned rows makes y-addressing contiguous: a bilinear read at the last
owned row reaches the halo at base + W with no special case.

Semantics: identical to models/hector.py (line-mode updates are bitwise equal —
the free/occ masks are unions over beams, invariant to sharding; matcher sums
differ from the dense [9,N] reduce only by float summation order).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import HectorConfig
from ..core.geometry import deg_diff, dotnet_round, normalize_angle, rad_diff
from ..ops.rasterize import hector_line_cells
from ..ops.gn import _solve_scalar
from . import hector


class ShardedHectorState(NamedTuple):
    local_maps: jnp.ndarray         # f32[T, local_cells] per-tile flat tables
    match_pose: jnp.ndarray         # f32[3] (replicated)
    last_update_pose: jnp.ndarray   # f32[3] (replicated)


# --------------------------- static layout helpers ---------------------------

def level_rows(cfg: HectorConfig, n_tiles: int) -> Tuple[int, ...]:
    """Owned rows per tile for each level: ceil(width / n_tiles).

    Levels need NOT divide evenly — the last tile(s) own padding rows beyond
    the grid (never read or written: every row index is masked against the
    real width before use), so any tile count works on any pyramid."""
    return tuple(-(-s // n_tiles) for s in cfg.level_sizes)


def local_level_offsets(cfg: HectorConfig, n_tiles: int) -> Tuple[int, ...]:
    """Start offset of each level inside a tile's flat local table."""
    out, off = [], 0
    for s, rows in zip(cfg.level_sizes, level_rows(cfg, n_tiles)):
        out.append(off)
        off += (rows + 1) * s             # owned rows + 1 halo row
    return tuple(out)


def local_cells(cfg: HectorConfig, n_tiles: int) -> int:
    return sum((rows + 1) * s for s, rows in zip(cfg.level_sizes,
                                                 level_rows(cfg, n_tiles)))


def _beam_pad(n: int, n_search: int) -> int:
    """Beam axis padded to a lane multiple AND divisible by the search axis."""
    pad = max(256, -(-n // 128) * 128)
    while pad % n_search:
        pad += 128
    return pad


# ------------------------------ shard/unshard -------------------------------

def shard_tiles_host(dense_maps, cfg: HectorConfig, n_tiles: int):
    """Tile a dense concatenated pyramid into per-tile local tables (owned
    rows + halo per level).  Accepts numpy or jnp input but always computes
    with jnp and returns a DEVICE array ([n_tiles, local_cells]).
    Also the host-side oracle for what each mesh tile must hold (used by the
    true multi-process test, tests/_multiproc_worker.py)."""
    dense_maps = jnp.asarray(dense_maps)
    np_ = jnp
    lrows = level_rows(cfg, n_tiles)
    tiles = []
    for t in range(n_tiles):
        parts = []
        for level in range(cfg.num_levels):
            s = cfg.level_sizes[level]
            rows = lrows[level]
            grid = dense_maps[cfg.level_offsets[level]:
                              cfg.level_offsets[level] + s * s].reshape(s, s)
            owned = grid[t * rows:(t + 1) * rows]
            if owned.shape[0] < rows:     # last tile(s): pad beyond the grid
                owned = np_.concatenate(
                    [owned, np_.zeros((rows - owned.shape[0], s), grid.dtype)])
            halo = (grid[(t + 1) * rows] if (t + 1) * rows < s
                    else np_.zeros(s, grid.dtype))
            parts.append(np_.concatenate([owned, halo[None]]).reshape(-1))
        tiles.append(np_.concatenate(parts))
    return np_.stack(tiles)


def shard_state(mesh: Mesh, dense: hector.HectorState, cfg: HectorConfig,
                tile_axis: str = "tile") -> ShardedHectorState:
    """Split a dense HectorState's concatenated pyramid into per-tile local
    tables (owned rows + halo per level) sharded over `tile_axis`."""
    n_tiles = mesh.shape[tile_axis]
    local = jax.device_put(shard_tiles_host(dense.maps, cfg, n_tiles),
                           NamedSharding(mesh, P(tile_axis)))
    rep = NamedSharding(mesh, P())
    return ShardedHectorState(
        local_maps=local,
        match_pose=jax.device_put(dense.match_pose, rep),
        last_update_pose=jax.device_put(dense.last_update_pose, rep))


def unshard_maps(state: ShardedHectorState, cfg: HectorConfig) -> jnp.ndarray:
    """Reassemble the dense concatenated pyramid (drops halo rows)."""
    n_tiles = state.local_maps.shape[0]
    loffs = local_level_offsets(cfg, n_tiles)
    lrows = level_rows(cfg, n_tiles)
    levels = []
    for level in range(cfg.num_levels):
        s = cfg.level_sizes[level]
        rows = lrows[level]
        per_tile = [state.local_maps[t, loffs[level]:
                                     loffs[level] + rows * s].reshape(rows, s)
                    for t in range(n_tiles)]
        levels.append(jnp.concatenate(per_tile)[:s].reshape(-1))
    return jnp.concatenate(levels)


def to_dense(state: ShardedHectorState, cfg: HectorConfig) -> hector.HectorState:
    return hector.HectorState(maps=unshard_maps(state, cfg),
                              match_pose=state.match_pose,
                              last_update_pose=state.last_update_pose)


def init(mesh: Mesh, cfg: HectorConfig, start_pose,
         tile_axis: str = "tile") -> ShardedHectorState:
    return shard_state(mesh, hector.init(cfg, start_pose), cfg, tile_axis)


# ----------------------------- the SPMD step --------------------------------

def _local_gn_reduce(local, loff, width, rows, r0, height, scale, pose_px,
                     X, Y, valid, axes, matcher_mode: str = "gather"):
    """Partial [11]-row GN reduction over (own beams x own rows), psum'd over
    both mesh axes — the sharded twin of ops.gn._fused_gn_core's reduction.

    matcher_mode (trace-time): "gather" fetches the 4 bilinear neighbors with
    take(); "onehot_highest"/"onehot_bf16" fetch them as two one-hot ROW
    matmuls against this tile's [rows+1, width] level view (owned rows + the
    halo row) plus lane selects — the sharded twin of
    ops.gn.fused_gn_iteration_onehot_stats, so the multi-device pipeline has
    the same one-hot form as the single-device matcher.  "onehot_highest"
    selects entries exactly (1.0*x
    + exact zeros) and is bit-identical to the gather form
    (tests/test_hector_sharded.py); "onehot_bf16" rounds the table to
    bf16."""
    sr = jnp.sin(pose_px[2]) * scale
    cr = jnp.cos(pose_px[2]) * scale
    mx = cr * X - sr * Y + pose_px[0]
    my = sr * X + cr * Y + pose_px[1]
    in_b = (valid & (mx >= 0.0) & (mx <= width - 2) & (my >= 0.0)
            & (my <= height - 2))
    xi = jnp.clip(mx.astype(jnp.int32), 0, width - 2)
    yi = jnp.clip(my.astype(jnp.int32), 0, height - 2)
    mine = in_b & (yi >= r0) & (yi < r0 + rows)
    ly = jnp.where(mine, yi - r0, 0)
    lx = jnp.where(mine, xi, 0)
    if matcher_mode == "gather":
        base = loff + ly * width + lx
        # halo row sits right after the owned rows: base + width is valid
        # even on the last owned row
        idx = jnp.stack([base, base + 1, base + width, base + width + 1])
        raw = jnp.take(local, idx)
    else:
        # ly <= rows-1 so ly+1 <= rows: both rows live inside the view
        # (the halo row is the view's last row)
        view = jax.lax.dynamic_slice(
            local, (loff,), ((rows + 1) * width,)).reshape(rows + 1, width)
        # bf16 one-hot masks in the non-exact mode (ops/gn.py: 0/1 exact in
        # bf16; mask materialization is the kernel's real cost)
        oh_dt = (jnp.float32 if matcher_mode == "onehot_highest"
                 else jnp.bfloat16)
        ry = jnp.concatenate([ly, ly + 1])                       # [2N]
        oh_rows = (ry[:, None] == jnp.arange(rows + 1, dtype=ry.dtype)
                   ).astype(oh_dt)
        prec = (jax.lax.Precision.HIGHEST
                if matcher_mode == "onehot_highest" else None)
        tbl = view if matcher_mode == "onehot_highest" else view.astype(oh_dt)
        sel = jnp.dot(oh_rows, tbl,
                      precision=prec).astype(jnp.float32)        # [2N, width]
        lane = jnp.arange(width, dtype=lx.dtype)
        oh0 = (lx[:, None] == lane).astype(oh_dt)
        oh1 = ((lx + 1)[:, None] == lane).astype(oh_dt)
        n = X.shape[0]
        rlo, rhi = sel[:n], sel[n:]
        # order matches the gather stack: (y,x) (y,x+1) (y+1,x) (y+1,x+1)
        raw = jnp.stack([(rlo * oh0).sum(axis=1), (rlo * oh1).sum(axis=1),
                         (rhi * oh0).sum(axis=1),
                         (rhi * oh1).sum(axis=1)]).astype(jnp.float32)
    v = jax.nn.sigmoid(raw)
    fx = mx - xi
    fy = my - yi
    xf, yf = 1.0 - fx, 1.0 - fy
    val = (v[0] * xf + v[1] * fx) * yf + (v[2] * xf + v[3] * fx) * fy
    gx = -((v[0] - v[1]) * xf + (v[2] - v[3]) * fx)
    gy = -((v[0] - v[2]) * yf + (v[1] - v[3]) * fy)
    z = jnp.float32(0.0)
    gx = jnp.where(mine, gx, z)
    gy = jnp.where(mine, gy, z)
    fun = jnp.where(mine, 1.0 - val, z)
    rot = (-sr * X - cr * Y) * gx + (cr * X - sr * Y) * gy
    red = jnp.stack([gx * fun, gy * fun, rot * fun,
                     gx * gx, gx * gy, gx * rot,
                     gy * gy, gy * rot, rot * rot,
                     fun * fun, mine.astype(jnp.float32)]).sum(axis=1)
    return jax.lax.psum(red, axes)


def _level_update_local(local, loff, width, rows, r0, height, points_x,
                        points_y, valid, pose, scale, lof, loo, cap,
                        search_axis):
    """One level's occupancy update on this tile's rows from this device's beam
    shard; masks OR-combined over `search_axis`.  Bitwise equal to
    ops.logodds.update_occupancy on the reassembled grid."""
    theta = pose[2]
    c, s = jnp.cos(theta), jnp.sin(theta)
    tx, ty = pose[0], pose[1]
    # scan-cloud pose is zero in every model driver (simulator semantics)
    bx = tx * scale
    by = ty * scale
    begin = jnp.stack([dotnet_round(bx), dotnet_round(by)])
    ex = (c * points_x - s * points_y + tx) * scale
    ey = (s * points_x + c * points_y + ty) * scale
    end = jnp.stack([dotnet_round(ex), dotnet_round(ey)], axis=1)

    n = points_x.shape[0]
    begin_b = jnp.broadcast_to(begin, (n, 2))
    same = (end[:, 0] == begin[0]) & (end[:, 1] == begin[1])
    ok2 = lambda p: ((p[..., 0] >= 0) & (p[..., 0] < width) &
                     (p[..., 1] >= 0) & (p[..., 1] < height))
    beam_ok = valid & ~same & ok2(begin_b) & ok2(end)

    cells = hector_line_cells(begin_b, end, width, max_steps=height)
    cy = cells.flat // width
    cx = cells.flat - cy * width
    fmask = cells.mask & beam_ok[:, None] & (cy >= r0) & (cy < r0 + rows)
    lflat = jnp.where(fmask, (cy - r0) * width + cx, 0)

    ncells = rows * width
    free = jnp.zeros(ncells, jnp.int32).at[lflat.reshape(-1)].max(
        fmask.reshape(-1).astype(jnp.int32))
    omask = beam_ok & (end[:, 1] >= r0) & (end[:, 1] < r0 + rows)
    oflat = jnp.where(omask, (end[:, 1] - r0) * width + end[:, 0], 0)
    occ = jnp.zeros(ncells, jnp.int32).at[oflat].max(omask.astype(jnp.int32))

    # union of all beam shards' marks
    free = jax.lax.pmax(free, search_axis)
    occ = jax.lax.pmax(occ, search_axis)

    owned = jax.lax.dynamic_slice(local, (loff,), (ncells,))
    is_occ = occ > 0
    is_free = (free > 0) & ~is_occ
    owned = (owned + jnp.where(is_free, lof, 0.0)
             + jnp.where(is_occ & (owned < cap), loo, 0.0))
    return jax.lax.dynamic_update_slice(local, owned, (loff,))


def _halo_refresh_local(local, loff, width, rows, tile_axis):
    """Refresh this level's halo row from the south neighbor's first owned row."""
    n = jax.lax.axis_size(tile_axis)
    first_owned = jax.lax.dynamic_slice(local, (loff,), (width,))
    perm = [(i, i - 1) for i in range(1, n)]
    halo = jax.lax.ppermute(first_owned, tile_axis, perm)
    # the last tile receives zeros — its halo is never read (bilinear bounds)
    return jax.lax.dynamic_update_slice(local, halo, (loff + rows * width,))


def local_full_step(local, match_pose, last_update_pose, X, Y, valid, force,
                    cfg: HectorConfig, n_tiles: int,
                    tile_axis: str = "tile", search_axis: str = "search"):
    """Shard-local full Hector step — the body of make_step's shard_map,
    exposed so compositions (models/graph_slam_sharded) can run it inside
    their OWN shard_map over the same mesh axes.

    local: this tile's flat table f32[C] (NO leading shard dim); X/Y/valid are
    this device's beam shard (already lane-padded).  Returns
    (new_local f32[C], new_pose, new_last, HectorInfo) — pose/info replicated.
    """
    loffs = local_level_offsets(cfg, n_tiles)
    lrows = level_rows(cfg, n_tiles)
    axes = (tile_axis, search_axis)
    tile = jax.lax.axis_index(tile_axis)

    # ---------------- match: coarse-to-fine over the pyramid -----------
    any_valid = jax.lax.psum(jnp.sum(valid.astype(jnp.int32)),
                             search_axis) > 0
    estimate = match_pose
    ox, oy = cfg.offset
    iters = jnp.int32(0)
    fails = jnp.int32(0)
    resid_sum = jnp.float32(0.0)
    n_in = jnp.float32(0.0)
    for level in range(cfg.num_levels - 1, -1, -1):
        width = cfg.level_sizes[level]
        rows = lrows[level]
        r0 = tile * rows
        scale = 1.0 / cfg.level_resolutions[level]
        est_px = jnp.stack([estimate[0] * scale + ox,
                            estimate[1] * scale + oy, estimate[2]])
        n_iters = cfg.estimate_iterations[level]

        def one_iter(p):
            red = _local_gn_reduce(local, loffs[level], width, rows, r0,
                                   width, scale, p, X, Y, valid, axes,
                                   matcher_mode=cfg.matcher_mode)
            d0, d1, d2, H00, H01, H02, H11, H12, H22 = red[:9]
            s0, s1, s2, ok = _solve_scalar(H00, H01, H02, H11, H12, H22,
                                           d0, d1, d2, cfg.deriv_clamp,
                                           cfg.xy_step_clamp_px)
            return (jnp.stack([p[0] + s0, p[1] + s1, p[2] + s2]), ok,
                    red[9], red[10])

        if cfg.early_exit_tol > 0.0:
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
        estimate = jnp.stack([(est_px[0] - ox) / scale,
                              (est_px[1] - oy) / scale,
                              normalize_angle(est_px[2])])
    matched = jnp.where(any_valid, estimate, match_pose)
    if cfg.max_match_jump > 0.0:
        # reject physically-impossible per-scan jumps (models/hector.update)
        jump2 = jnp.sum((matched[:2] - match_pose[:2]) ** 2)
        matched = jnp.where(jump2 <= cfg.max_match_jump ** 2, matched,
                            match_pose)
    new_pose = jnp.where(force, match_pose, matched)

    # ---------------- motion gate (replicated scalars) ------------------
    dist2 = jnp.sum((new_pose[:2] - last_update_pose[:2]) ** 2)
    if cfg.angle_gate_compat:
        ang_gate = deg_diff(new_pose[2], last_update_pose[2]) \
            > cfg.min_angle_diff_for_map_update
    else:
        ang_gate = jnp.abs(rad_diff(new_pose[2], last_update_pose[2])) \
            > cfg.min_angle_diff_for_map_update
    do_update = ((dist2 > cfg.min_distance_diff_for_map_update ** 2)
                 | ang_gate | force)

    # ---------------- gated per-level update + halo refresh -------------
    def with_update(loc):
        for level in range(cfg.num_levels):
            width = cfg.level_sizes[level]
            rows = lrows[level]
            r0 = tile * rows
            scale = 1.0 / cfg.level_resolutions[level]
            loc = _level_update_local(
                loc, loffs[level], width, rows, r0, width, X, Y, valid,
                new_pose, scale, cfg.log_odds_free, cfg.log_odds_occupied,
                cfg.occupied_cap, search_axis)
            loc = _halo_refresh_local(loc, loffs[level], width, rows,
                                      tile_axis)
        return loc

    new_local = jax.lax.cond(do_update, with_update, lambda l: l, local)
    new_last = jnp.where(do_update, new_pose, last_update_pose)
    info = hector.HectorInfo(
        map_updated=do_update,
        residual=resid_sum / jnp.maximum(n_in, 1.0),
        gn_iterations=iters, solve_failures=fails)
    return new_local, new_pose, new_last, info



def make_step(mesh: Mesh, cfg: HectorConfig, num_beams: int,
              tile_axis: str = "tile", search_axis: str = "search"):
    """Build the jitted sharded per-scan step.

    Returns step(state, points f32[N,2], valid bool[N], force bool)
            -> (state, HectorInfo)  — same contract as models.hector.update.
    """
    if cfg.matcher_mode == "pallas":
        raise ValueError("matcher_mode='pallas' is single-device: the sharded "
                         "matcher psums (H, dTr) every GN iteration; use "
                         "'gather' or a one-hot mode")
    n_tiles = mesh.shape[tile_axis]
    n_search = mesh.shape[search_axis]
    pad = _beam_pad(num_beams, n_search)

    def local_step(local, match_pose, last_update_pose, X, Y, valid, force):
        new_local, pose, last, info = local_full_step(
            local[0], match_pose, last_update_pose, X, Y, valid, force,
            cfg, n_tiles, tile_axis, search_axis)
        return new_local[None], pose, last, info

    sharded = shard_map(
        local_step, mesh=mesh,
        in_specs=(P(tile_axis), P(), P(), P(search_axis), P(search_axis),
                  P(search_axis), P()),
        out_specs=(P(tile_axis), P(), P(), P()),
        check_vma=True)

    def pad_beams(x, fill):
        n = x.shape[0]
        if n >= pad:
            return x
        return jnp.concatenate(
            [x, jnp.full((pad - n,) + x.shape[1:], fill, x.dtype)])

    @jax.jit
    def step(state: ShardedHectorState, points, valid, force):
        X = pad_beams(points[:, 0], 0.0)
        Y = pad_beams(points[:, 1], 0.0)
        V = pad_beams(valid, False)
        local, pose, last, info = sharded(
            state.local_maps, state.match_pose, state.last_update_pose,
            X, Y, V, jnp.asarray(force))
        return ShardedHectorState(local, pose, last), info

    return step
