"""Distributed graph-SLAM: the full north-star pipeline as ONE SPMD program.

BASELINE.json north star: "pose-graph layer with loop closures solved by
distributed Gauss-Newton ... with keyframes and map tiles sharded across"
devices.  models/graph_slam.py composes the DENSE pieces;
this module composes the SHARDED ones — per scan, inside one shard_map over a
('tile' x 'search') mesh:

  * scan-to-map matching + gated occupancy update via the row-tiled,
    beam-sharded Hector step (hector_sharded.local_full_step: ppermute halos
    over 'tile', psum'd (H,dTr) over both axes);
  * keyframe gate + pose-graph bookkeeping on replicated scalars (the graph
    itself is tiny: K pose triples + edge lists);
  * KEYFRAME CLOUD STORAGE sharded over 'search' — each shard owns K/S
    complete clouds (the rebuild_maps_sharded layout); a loop-closure
    candidate's cloud is fetched with one psum broadcast (the owner
    contributes, everyone else zeros);
  * loop-closure scan-to-scan matching replicated (frontend.match_scans on a
    small local grid — cheap next to the main matcher);
  * pose-graph optimization by the NODE-SHARDED Schur GN
    (graph/schur.schur_local_step over 'search': interiors eliminated
    locally, one psum of the packed separator system per iteration), with the
    separator-overflow count surfaced in the per-scan info — never silent.

Semantics match models/graph_slam.update to float tolerance (the matcher and
Schur solve differ from dense only by float summation order;
tests/test_graph_slam.py::test_sharded_graph_slam_matches_dense).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import HectorConfig, PoseGraphConfig
from ..core.geometry import normalize_angle, pose_between
from ..core.scan import Scan
from ..graph import frontend, posegraph, schur
from . import graph_slam, hector, hector_sharded


class ShardedGraphSlamState(NamedTuple):
    local_maps: jnp.ndarray        # f32[T, C] per-tile pyramid (P(tile))
    match_pose: jnp.ndarray        # f32[3] replicated
    last_update_pose: jnp.ndarray  # f32[3] replicated
    graph: posegraph.PoseGraph     # replicated (small)
    kf_points: jnp.ndarray         # f32[K, N, 2] keyframe clouds (P(search))
    kf_valid: jnp.ndarray          # bool[K, N] (P(search))
    last_kf_pose: jnp.ndarray      # f32[3] replicated
    loop_count: jnp.ndarray        # i32[] replicated


class ShardedGraphSlamInfo(NamedTuple):
    keyframe_added: jnp.ndarray
    loop_closed: jnp.ndarray
    map_updated: jnp.ndarray
    sep_overflow: jnp.ndarray      # i32[] — nonzero = Schur capacity breached


def init(mesh: Mesh, hcfg: HectorConfig, gcfg: PoseGraphConfig, start_pose,
         num_beams: int, tile_axis: str = "tile",
         search_axis: str = "search") -> ShardedGraphSlamState:
    """Shard a fresh dense GraphSlamState over the mesh."""
    return shard_dense(mesh, graph_slam.init(hcfg, gcfg, start_pose,
                                             num_beams),
                       hcfg, tile_axis, search_axis)


def shard_dense(mesh: Mesh, dense: graph_slam.GraphSlamState,
                hcfg: HectorConfig, tile_axis: str = "tile",
                search_axis: str = "search") -> ShardedGraphSlamState:
    hs = hector_sharded.shard_state(mesh, dense.hector, hcfg, tile_axis)
    rep = NamedSharding(mesh, P())
    return ShardedGraphSlamState(
        local_maps=hs.local_maps,
        match_pose=hs.match_pose,
        last_update_pose=hs.last_update_pose,
        graph=jax.device_put(dense.graph, rep),
        kf_points=jax.device_put(dense.kf_points,
                                 NamedSharding(mesh, P(search_axis))),
        kf_valid=jax.device_put(dense.kf_valid,
                                NamedSharding(mesh, P(search_axis))),
        last_kf_pose=jax.device_put(dense.last_kf_pose, rep),
        loop_count=jax.device_put(dense.loop_count, rep))


def to_dense(state: ShardedGraphSlamState,
             hcfg: HectorConfig) -> graph_slam.GraphSlamState:
    """Reassemble a dense GraphSlamState (host-side; for tests/checkpoints)."""
    hs = hector_sharded.ShardedHectorState(state.local_maps, state.match_pose,
                                           state.last_update_pose)
    return graph_slam.GraphSlamState(
        hector=hector_sharded.to_dense(hs, hcfg),
        graph=state.graph,
        kf_points=jnp.asarray(state.kf_points),
        kf_valid=jnp.asarray(state.kf_valid),
        last_kf_pose=state.last_kf_pose,
        loop_count=state.loop_count)


def make_step(mesh: Mesh, hcfg: HectorConfig, gcfg: PoseGraphConfig,
              num_beams: int,
              mcfg: frontend.ScanMatchConfig | None = None,
              opt_iterations: int = 3, sep_capacity: int = 16,
              tile_axis: str = "tile", search_axis: str = "search"):
    """Build the jitted distributed graph-SLAM per-scan step.

    Returns step(state, points f32[N,2], valid bool[N], force bool)
            -> (state, ShardedGraphSlamInfo) — the sharded twin of
    models.graph_slam.update (same keyframe/loop schedule; the dense model's
    per-keyframe optimize becomes `opt_iterations` node-sharded Schur GN
    steps over `search_axis` — a fixed count, not the dense path's
    1-normally / 3-on-closure incremental split, since the Schur steps are
    the collective whose cost the mesh amortizes).
    """
    if mcfg is None:
        mcfg = frontend.ScanMatchConfig()
    n_tiles = mesh.shape[tile_axis]
    n_search = mesh.shape[search_axis]
    kf_k = gcfg.max_keyframes
    assert kf_k % n_search == 0, (kf_k, n_search)
    per = kf_k // n_search
    pad = hector_sharded._beam_pad(num_beams, n_search)

    def _schur_optimize_local(g: posegraph.PoseGraph):
        overflow = jnp.zeros((), jnp.int32)
        for _ in range(opt_iterations):
            new_poses, of = schur.schur_local_step(
                g.poses, g.node_valid, g.edge_i, g.edge_j, g.edge_meas,
                g.edge_w, g.edge_valid, n_shards=n_search,
                sep_capacity=sep_capacity, anchor_weight=1e6, damping=1e-6,
                axis=search_axis, huber_delta=gcfg.huber_delta)
            g = g._replace(poses=new_poses)
            overflow = jnp.maximum(overflow, of)
        return g, overflow

    def _spawn_keyframe_local(g, kf_pts, kf_val, pts_full, val_full, pose):
        """Sharded twin of graph_slam._spawn_keyframe (same graph arithmetic;
        cloud storage and GN solve distributed)."""
        srank = jax.lax.axis_index(search_axis)
        prev_idx = g.num_nodes - 1
        prev_pose = g.poses[prev_idx]
        room = posegraph.has_node_room(g)
        g, new_idx = posegraph.add_node(g, pose)
        rel = pose_between(prev_pose, pose)
        g = posegraph.add_edge(g, prev_idx, new_idx, rel,
                               gcfg.odom_edge_weights, enable=room)

        # ---- store the cloud on its owner shard -----------------------------
        owner = new_idx // per
        kloc = jnp.where(owner == srank, new_idx - owner * per, 0)
        write = room & (owner == srank)
        kf_pts = kf_pts.at[kloc].set(
            jnp.where(write, pts_full, kf_pts[kloc]))
        kf_val = kf_val.at[kloc].set(
            jnp.where(write, val_full, kf_val[kloc]))

        # ---- loop closure: nearest valid candidate by proximity -------------
        cand_mask = frontend.loop_candidates(g.poses, g.node_valid, new_idx,
                                             gcfg.loop_closure_radius, 5)
        d = jnp.linalg.norm(g.poses[:, :2] - pose[None, :2], axis=1)
        d = jnp.where(cand_mask, d, jnp.inf)
        cand = jnp.argmin(d)
        has_cand = jnp.isfinite(d[cand]) & room

        # fetch the candidate's cloud from its owner (one psum broadcast)
        cowner = cand // per
        cloc = jnp.where(cowner == srank, cand - cowner * per, 0)
        mine = (cowner == srank)
        cpts = jnp.where(mine,
                         jax.lax.dynamic_index_in_dim(kf_pts, cloc, 0,
                                                      keepdims=False), 0.0)
        cval = jnp.where(mine,
                         jax.lax.dynamic_index_in_dim(kf_val, cloc, 0,
                                                      keepdims=False)
                         .astype(jnp.int32), 0)
        cpts = jax.lax.psum(cpts, search_axis)
        cval = jax.lax.psum(cval, search_axis) > 0

        def close_loop(g):
            cand_scan = Scan(cpts, cval, jnp.zeros(3, jnp.float32))
            qry_scan = Scan(pts_full, val_full, jnp.zeros(3, jnp.float32))
            init_rel = pose_between(g.poses[cand], pose)
            rel, q = frontend.match_scans(cand_scan, qry_scan, init_rel, mcfg)
            ok = (jnp.linalg.norm(rel[:2] - init_rel[:2])
                  < gcfg.loop_max_translation) \
                & (q.inlier_frac > gcfg.loop_min_inlier_frac)
            g2 = posegraph.add_edge(g, cand, new_idx, rel,
                                    gcfg.loop_edge_weights)
            g2 = jax.tree.map(lambda a, b: jnp.where(ok, a, b), g2, g)
            return g2, ok

        def no_loop(g):
            return g, jnp.asarray(False)

        g, looped = jax.lax.cond(has_cand, close_loop, no_loop, g)

        # ---- distributed optimization: node-sharded Schur GN -----------------
        g, overflow = _schur_optimize_local(g)
        return g, kf_pts, kf_val, looped, overflow

    def local_step(local, match_pose, last_up, X, Y, V, pts_full, val_full,
                   force, g, kf_pts, kf_val, last_kf_pose, loop_count):
        local = local[0]
        new_local, pose, new_last, hinfo = hector_sharded.local_full_step(
            local, match_pose, last_up, X, Y, V, force,
            hcfg, n_tiles, tile_axis, search_axis)

        due = frontend.keyframe_due(last_kf_pose, pose, gcfg.keyframe_dist,
                                    gcfg.keyframe_angle)

        def with_kf(args):
            g, kf_pts, kf_val = args
            g2, kp2, kv2, looped, overflow = _spawn_keyframe_local(
                g, kf_pts, kf_val, pts_full, val_full, pose)
            # re-anchor the live matcher to the optimized current keyframe
            opt_pose = g2.poses[g2.num_nodes - 1]
            anchored = opt_pose.at[2].set(normalize_angle(opt_pose[2]))
            return g2, kp2, kv2, anchored, pose, looped, overflow

        def without_kf(args):
            g, kf_pts, kf_val = args
            return (g, kf_pts, kf_val, pose, last_kf_pose,
                    jnp.asarray(False), jnp.zeros((), jnp.int32))

        (g, kf_pts, kf_val, new_match, new_last_kf, looped,
         overflow) = jax.lax.cond(due, with_kf, without_kf,
                                  (g, kf_pts, kf_val))

        info = ShardedGraphSlamInfo(keyframe_added=due, loop_closed=looped,
                                    map_updated=hinfo.map_updated,
                                    sep_overflow=overflow)
        return (new_local[None], new_match, new_last, g, kf_pts, kf_val,
                new_last_kf, loop_count + looped, info)

    sharded = shard_map(
        local_step, mesh=mesh,
        in_specs=(P(tile_axis), P(), P(), P(search_axis), P(search_axis),
                  P(search_axis), P(), P(), P(), P(), P(search_axis),
                  P(search_axis), P(), P()),
        out_specs=(P(tile_axis), P(), P(), P(), P(search_axis),
                   P(search_axis), P(), P(), P()),
        check_vma=False)

    def pad_beams(x, fill):
        n = x.shape[0]
        if n >= pad:
            return x
        return jnp.concatenate(
            [x, jnp.full((pad - n,) + x.shape[1:], fill, x.dtype)])

    @jax.jit
    def step(state: ShardedGraphSlamState, points, valid, force):
        X = pad_beams(points[:, 0], 0.0)
        Y = pad_beams(points[:, 1], 0.0)
        V = pad_beams(valid, False)
        (local, match, last, g, kf_pts, kf_val, last_kf, loops,
         info) = sharded(state.local_maps, state.match_pose,
                         state.last_update_pose, X, Y, V, points, valid,
                         jnp.asarray(force), state.graph, state.kf_points,
                         state.kf_valid, state.last_kf_pose, state.loop_count)
        return ShardedGraphSlamState(local, match, last, g, kf_pts, kf_val,
                                     last_kf, loops), info

    return step
