"""Fleet serving: many independent SLAM instances batched on one chip.

The production deployment mode with no reference counterpart: a server-side GPU
tracks B robots at once.  Each instance has its own maps/pose; a 3-level
400x400 Hector instance is ~1 MB of maps, so hundreds of instances fit in HBM.

Split execution model (the round-2 throughput fix, PERF.md):

  * MATCHING is batched through ops/gn.fused_gn_iteration_batch: all instance
    pyramids view as ONE flat table so each GN iteration is a single
    non-batched gather (a vmapped matcher's batched gather can lower to a
    per-instance loop), or runs as one matcher-kernel program per instance
    (matcher_mode="pallas", ops/pallas_match.py);
  * MAP UPDATES run as a lax.scan over the instance axis with a real lax.cond
    per instance.  Under vmap the motion gate lowers to select, so EVERY
    instance pays the serialized occupancy scatter EVERY scan (the round-1
    10x regression); under scan the cond stays a genuine branch, so only the
    ~1-in-18 instances whose gate fires (reference motion-gate statistics,
    HectorSLAMProcessor.cs:107-109) pay it.  Expected cost per batch-scan:
    B/18 updates instead of B.

Semantics are unchanged: identical to per-instance models/hector.update
(tests/test_fleet.py asserts exact agreement).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..core.config import HectorConfig
from ..core.geometry import deg_diff, normalize_angle, rad_diff
from ..core.scan import Scan
from ..ops import gn, pallas_match
from . import hector


def init_fleet(cfg: HectorConfig, start_poses) -> hector.HectorState:
    """Batched HectorState for B instances; start_poses f32[B, 3].

    `maps` is carried FLAT as f32[B*C] (C = cells per instance pyramid,
    `fleet_cells(cfg)`): the matcher gathers with explicit b*C + idx indices,
    and a flat carry means the gather operand needs no per-iteration reshape/
    relayout of the whole table (PERF.md rule 1).  Use
    `states.maps.reshape(B, -1)` for per-instance views.
    """
    start_poses = jnp.asarray(start_poses, jnp.float32)

    def one(p):
        return hector.init(cfg, p)

    states = jax.vmap(one)(start_poses)
    return states._replace(maps=states.maps.reshape(-1))


def fleet_cells(cfg: HectorConfig) -> int:
    """Cells in one instance's concatenated pyramid table."""
    return sum(w * w for w in cfg.level_sizes)


def _match_batch(flat, cells, points, valid, hints, cfg: HectorConfig):
    """Coarse-to-fine pyramid match for B instances (models/hector.match
    semantics, batched).  flat f32[B*cells]; points f32[B, N, 2];
    hints f32[B, 3].
    Returns (poses f32[B, 3], MatchStats with [B]-shaped fields)."""
    b = points.shape[0]
    if cfg.match_subsample > 1:
        # matcher-only beam subsampling: map updates keep all beams
        points = points[:, ::cfg.match_subsample]
        valid = valid[:, ::cfg.match_subsample]
    n = points.shape[1]
    pad = hector._lane_pad(n)
    if n < pad:
        z = jnp.zeros((b, pad - n), jnp.float32)
        X = jnp.concatenate([points[:, :, 0], z], axis=1)
        Y = jnp.concatenate([points[:, :, 1], z], axis=1)
        V = jnp.concatenate([valid, jnp.zeros((b, pad - n), bool)], axis=1)
    else:
        X, Y, V = points[:, :, 0], points[:, :, 1], valid

    any_valid = jnp.any(valid, axis=1)
    if cfg.matcher_mode == "pallas":
        # one kernel program per instance, all in parallel
        # (ops/pallas_match.py; per instance the hector "pallas" match)
        poses, fails, resid_sum, n_in = pallas_match.match(
            flat, pallas_match.levels_of(cfg), X, Y, V, hints,
            **pallas_match.solver_args(cfg))
        n_iters = sum(cfg.estimate_iterations[:cfg.num_levels])
        stats = hector.MatchStats(
            residual=resid_sum / jnp.maximum(n_in, 1.0),
            iterations=jnp.full(b, n_iters, jnp.int32),
            solve_failures=fails,
            in_map_frac=n_in / jnp.maximum(
                jnp.sum(V.astype(jnp.float32), axis=1), 1.0))
        return jnp.where(any_valid[:, None], poses, hints), stats

    estimate = hints
    ox, oy = cfg.offset
    iters = jnp.int32(0)
    fails = jnp.zeros(b, jnp.int32)
    resid_sum = jnp.zeros(b, jnp.float32)
    n_in = jnp.zeros(b, jnp.float32)
    onehot = cfg.matcher_mode.startswith("onehot")
    if onehot:
        # per-level padded [B, w_l, lanes_l] views per batch-scan;
        # iterations then run batched one-hot matmuls
        # (ops/gn.fused_gn_iteration_batch_onehot)
        tables3d = gn.build_row_tables_batch(flat, b, cfg)
        prec = "highest" if cfg.matcher_mode == "onehot_highest" else "bf16"
    for level in range(cfg.num_levels - 1, -1, -1):
        width = cfg.level_sizes[level]
        offset = cfg.level_offsets[level]
        scale = 1.0 / cfg.level_resolutions[level]
        est_px = jnp.stack([estimate[:, 0] * scale + ox,
                            estimate[:, 1] * scale + oy,
                            estimate[:, 2]], axis=1)
        n_iters = cfg.estimate_iterations[level]

        if onehot:
            def one_iter(p, level=level):
                return gn.fused_gn_iteration_batch_onehot(
                    tables3d[level], 0, width, scale, p, X, Y, V,
                    cfg.deriv_clamp, cfg.xy_step_clamp_px, cfg.gn_damping,
                    precision=prec)
        else:
            def one_iter(p, level=level):
                return gn.fused_gn_iteration_batch(
                    flat, cells, offset, width, scale, p, X, Y, V,
                    cfg.deriv_clamp, cfg.xy_step_clamp_px, cfg.gn_damping)

        if cfg.early_exit_tol > 0.0:
            # batch-wide convergence: stop when EVERY instance's step is tiny
            tol2 = cfg.early_exit_tol ** 2

            def cond(carry):
                i, p, moved2, f, rs, ni = carry
                return (i < n_iters) & (jnp.max(moved2) > tol2)

            def body(carry):
                i, p, _, f, rs, ni = carry
                p2, ok, rs2, ni2 = one_iter(p)
                return (i + 1, p2, jnp.sum((p2 - p) ** 2, axis=1),
                        f + (~ok).astype(jnp.int32), rs2, ni2)

            li, est_px, _, fails, resid_sum, n_in = jax.lax.while_loop(
                cond, body, (jnp.int32(0), est_px,
                             jnp.full(b, jnp.inf, jnp.float32), fails,
                             resid_sum, n_in))
            iters = iters + li
        else:
            for _ in range(n_iters):
                est_px, ok, resid_sum, n_in = one_iter(est_px)
                fails = fails + (~ok).astype(jnp.int32)
            iters = iters + n_iters
        th = jax.vmap(normalize_angle)(est_px[:, 2])
        estimate = jnp.stack([(est_px[:, 0] - ox) / scale,
                              (est_px[:, 1] - oy) / scale, th], axis=1)
    poses = jnp.where(any_valid[:, None], estimate, hints)
    stats = hector.MatchStats(
        residual=resid_sum / jnp.maximum(n_in, 1.0),
        iterations=jnp.broadcast_to(iters, (b,)), solve_failures=fails,
        in_map_frac=n_in / jnp.maximum(
            jnp.sum(V.astype(jnp.float32), axis=1), 1.0))
    return poses, stats


def update_fleet(states: hector.HectorState, points, valid, cfg: HectorConfig,
                 map_without_matching=False) -> Tuple[hector.HectorState,
                                                      hector.HectorInfo]:
    """One scan step for every instance; points f32[B, N, 2], valid bool[B, N].

    states.maps is the FLAT f32[B*C] fleet table (see init_fleet)."""
    b = points.shape[0]
    cells = fleet_cells(cfg)
    force = jnp.broadcast_to(jnp.asarray(map_without_matching), (b,))

    # ---- phase 1: batched matching (ONE flat gather per GN iteration — a
    # vmapped matcher serializes per instance, ops/gn.fused_gn_iteration_batch)
    matched, mstats = _match_batch(states.maps, cells, points, valid,
                                   states.match_pose, cfg)
    if cfg.min_match_in_map_frac > 0.0:
        # reject matches resting on too few in-map beams (see hector.update)
        matched = jnp.where(
            (mstats.in_map_frac >= cfg.min_match_in_map_frac)[:, None],
            matched, states.match_pose)
    if cfg.max_match_jump > 0.0:
        # reject physically-impossible per-scan jumps (degenerate-view solves)
        jump2 = jnp.sum((matched[:, :2] - states.match_pose[:, :2]) ** 2,
                        axis=1)
        matched = jnp.where((jump2 <= cfg.max_match_jump ** 2)[:, None],
                            matched, states.match_pose)
    match_pose = jnp.where(force[:, None], states.match_pose, matched)

    # ---- phase 2: vectorized motion gates (HectorSLAMProcessor.cs:107-109) -
    dist2 = jnp.sum((match_pose[:, :2] - states.last_update_pose[:, :2]) ** 2,
                    axis=1)
    if cfg.angle_gate_compat:
        ang_gate = jax.vmap(deg_diff)(match_pose[:, 2],
                                      states.last_update_pose[:, 2]) \
            > cfg.min_angle_diff_for_map_update
    else:
        ang_gate = jnp.abs(jax.vmap(rad_diff)(
            match_pose[:, 2], states.last_update_pose[:, 2])) \
            > cfg.min_angle_diff_for_map_update
    do_update = ((dist2 > cfg.min_distance_diff_for_map_update ** 2)
                 | ang_gate | force)

    # ---- phase 3: gated updates, sequential over a fixed update budget -----
    # Scan over min(B, update_capacity) slots instead of all B instances: the
    # per-iteration loop overhead otherwise dominates when almost no gate
    # fires.  Instances beyond the budget defer gracefully — their gate
    # condition stays true (last_update_pose unchanged), so they update on the
    # next scan.  With the reference's ~1-in-18 gate statistics, bursts beyond
    # the budget are rare.
    #
    # The scan carries ONLY the [cap, cells] chosen rows, NOT the whole
    # [B*cells] table: carrying the full table makes every slot's
    # dynamic_update_slice a candidate full-table copy.  Chosen rows are
    # row-gathered before and row-scattered after — 2*cap*cells of
    # contiguous traffic.
    cap = min(b, cfg.fleet_update_capacity)
    order = jnp.argsort(~do_update, stable=True)      # firing instances first
    chosen = order[:cap].astype(jnp.int32)            # distinct indices
    chosen_gate = do_update[chosen]

    maps_2d = states.maps.reshape(b, cells)
    chosen_maps = jnp.take(maps_2d, chosen, axis=0)   # [cap, cells]

    def body(_, inp):
        m, gate, pose, pts, v = inp

        def do(m):
            cloud = Scan(pts, v, jnp.zeros(3, jnp.float32))
            return hector.update_maps(m, cloud, pose, cfg)

        m2 = jax.lax.cond(gate, do, lambda m: m, m)
        return 0, m2

    _, updated = jax.lax.scan(
        body, 0,
        (chosen_maps, chosen_gate, match_pose[chosen], points[chosen],
         valid[chosen]))
    new_maps = maps_2d.at[chosen].set(updated).reshape(-1)

    did_update = jnp.zeros(b, bool).at[chosen].set(chosen_gate)
    new_last = jnp.where(did_update[:, None], match_pose,
                         states.last_update_pose)
    info = hector.HectorInfo(map_updated=did_update, residual=mstats.residual,
                             gn_iterations=mstats.iterations,
                             solve_failures=mstats.solve_failures)
    return hector.HectorState(new_maps, match_pose, new_last), info


def replay_fleet(states: hector.HectorState, radii, valids, angles,
                 cfg: HectorConfig):
    """On-device replay over T scans for all B instances: radii f32[T, B, N].

    Returns (final states, match poses f32[T, B, 3]).
    """
    def body(sts, inp):
        r, v = inp
        pts = jnp.stack([r * jnp.cos(angles)[None, :],
                         r * jnp.sin(angles)[None, :]], -1)
        sts, info = update_fleet(sts, pts, v, cfg)
        return sts, sts.match_pose

    return jax.lax.scan(body, states, (radii, valids))


# --------------------------- fleet over the mesh -----------------------------
#
# Multi-device serving: instances are independent, so
# the instance axis shards embarrassingly — each device runs the single-chip
# fleet on its B/S slice with its slice of the flat map table kept local (no
# collectives at all).  Semantics: EXACTLY S independent local fleets; note
# the phase-3 update budget (cfg.fleet_update_capacity) applies PER SHARD, so
# total capacity scales with the mesh — the desired serving behavior.

def make_fleet_step(mesh, cfg: HectorConfig, axis: str = "search"):
    """Jitted sharded fleet step: step(states, points f32[B,N,2],
    valid bool[B,N], force bool) -> (states, HectorInfo), with the instance
    axis (and the flat [B*C] map table) sharded over `axis`.
    B must divide by the axis size."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def local(maps, match_pose, last_up, points, valid, force):
        sts = hector.HectorState(maps, match_pose, last_up)
        sts2, info = update_fleet(sts, points, valid, cfg, force)
        return sts2.maps, sts2.match_pose, sts2.last_update_pose, info

    sharded = shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
        check_vma=False)

    @jax.jit
    def step(states: hector.HectorState, points, valid, force=False):
        b = points.shape[0]
        assert b % mesh.shape[axis] == 0, (b, mesh.shape[axis])
        maps, pose, last, info = sharded(states.maps, states.match_pose,
                                         states.last_update_pose, points,
                                         valid, jnp.asarray(force))
        return hector.HectorState(maps, pose, last), info

    return step


def make_fleet_replay(mesh, cfg: HectorConfig, axis: str = "search"):
    """Jitted sharded fleet replay: replay(states, radii f32[T,B,N],
    valids bool[T,B,N], angles f32[N]) -> (states, poses f32[T,B,3])."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def local(maps, match_pose, last_up, radii, valids, angles):
        sts = hector.HectorState(maps, match_pose, last_up)
        sts2, poses = replay_fleet(sts, radii, valids, angles, cfg)
        return sts2.maps, sts2.match_pose, sts2.last_update_pose, poses

    sharded = shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(None, axis), P(None, axis),
                  P()),
        out_specs=(P(axis), P(axis), P(axis), P(None, axis)),
        check_vma=False)

    @jax.jit
    def replay(states: hector.HectorState, radii, valids, angles):
        maps, pose, last, poses = sharded(states.maps, states.match_pose,
                                          states.last_update_pose, radii,
                                          valids, angles)
        return hector.HectorState(maps, pose, last), poses

    return replay
