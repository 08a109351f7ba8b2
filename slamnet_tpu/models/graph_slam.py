"""Graph-SLAM: HectorSLAM odometry + keyframe pose graph with loop closures.

The full-system composition required by BASELINE.json's north star (the reference
stops at scan-to-map matching; SURVEY.md §1 "no loop closure, no pose graph"):

  scan -> hector.update (local matching, live maps)
       -> keyframe gate (frontend.keyframe_due)
       -> odometry edge (relative pose between consecutive keyframes)
       -> loop-closure search (frontend.loop_candidates + match_scans)
       -> pose-graph GN optimization
       -> trajectory correction applied back to the live matcher pose

The LIVE occupancy pyramid is not rewritten on loop closure (that would be an
O(map) rewrite per scan); instead the optimized keyframe trajectory is the
product, and ``rebuild_maps`` re-rasterizes a clean pyramid from all stored
keyframe scans at their optimized poses — the offline "map finalization" pass.

Everything is fixed-shape: K keyframe slots with stored clouds, gated writes via
lax.cond.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..core.config import HectorConfig, PoseGraphConfig
from ..core.geometry import normalize_angle, pose_between, pose_compose
from ..core.scan import Scan
from ..graph import frontend, posegraph
from . import hector


class GraphSlamState(NamedTuple):
    hector: hector.HectorState
    graph: posegraph.PoseGraph
    kf_points: jnp.ndarray     # f32[K, N, 2] stored keyframe clouds
    kf_valid: jnp.ndarray      # bool[K, N]
    last_kf_pose: jnp.ndarray  # f32[3]
    loop_count: jnp.ndarray    # i32[] accepted loop closures


class GraphSlamInfo(NamedTuple):
    keyframe_added: jnp.ndarray
    loop_closed: jnp.ndarray
    map_updated: jnp.ndarray


def init(hcfg: HectorConfig, gcfg: PoseGraphConfig, start_pose,
         num_beams: int) -> GraphSlamState:
    g = posegraph.init(gcfg.max_keyframes, gcfg.max_edges)
    g, _ = posegraph.add_node(g, jnp.asarray(start_pose, jnp.float32))
    return GraphSlamState(
        hector=hector.init(hcfg, start_pose),
        graph=g,
        kf_points=jnp.zeros((gcfg.max_keyframes, num_beams, 2), jnp.float32),
        kf_valid=jnp.zeros((gcfg.max_keyframes, num_beams), bool),
        last_kf_pose=jnp.asarray(start_pose, jnp.float32),
        loop_count=jnp.zeros((), jnp.int32),
    )


def _spawn_keyframe(state: GraphSlamState, scan: Scan, pose,
                    gcfg: PoseGraphConfig,
                    mcfg: frontend.ScanMatchConfig) -> Tuple[GraphSlamState,
                                                             jnp.ndarray]:
    g = state.graph
    prev_idx = g.num_nodes - 1
    prev_pose = g.poses[prev_idx]

    # capacity guard: when the node table is full, EVERYTHING below must no-op
    # (an edge to a clamped index would silently constrain the wrong node)
    room = posegraph.has_node_room(g)
    g, new_idx = posegraph.add_node(g, pose)
    rel = pose_between(prev_pose, pose)
    g = posegraph.add_edge(g, prev_idx, new_idx, rel, gcfg.odom_edge_weights,
                           enable=room)

    safe = jnp.minimum(new_idx, state.kf_points.shape[0] - 1)
    kf_points = state.kf_points.at[safe].set(
        jnp.where(room, scan.points, state.kf_points[safe]))
    kf_valid = state.kf_valid.at[safe].set(
        jnp.where(room, scan.valid, state.kf_valid[safe]))

    # ---- loop closure: nearest valid candidate by proximity
    cand_mask = frontend.loop_candidates(g.poses, g.node_valid, new_idx,
                                         gcfg.loop_closure_radius, 5)
    d = jnp.linalg.norm(g.poses[:, :2] - pose[None, :2], axis=1)
    d = jnp.where(cand_mask, d, jnp.inf)
    cand = jnp.argmin(d)
    has_cand = jnp.isfinite(d[cand]) & room

    def close_loop(g):
        cand_scan = Scan(state.kf_points[cand], state.kf_valid[cand],
                         jnp.zeros(3, jnp.float32))
        init_rel = pose_between(g.poses[cand], pose)
        rel, q = frontend.match_scans(cand_scan, scan, init_rel, mcfg)
        # accept when the matcher stayed near its init (no divergence) AND the
        # query points actually land on the candidate's occupied cells —
        # gradient-based proxies cannot reject perceptual aliasing (a garbage
        # match converges with near-zero gradients)
        ok = (jnp.linalg.norm(rel[:2] - init_rel[:2])
              < gcfg.loop_max_translation) \
            & (q.inlier_frac > gcfg.loop_min_inlier_frac)
        g2 = posegraph.add_edge(g, cand, new_idx, rel, gcfg.loop_edge_weights)
        g2 = jax.tree.map(lambda a, b: jnp.where(ok, a, b), g2, g)
        return g2, ok

    def no_loop(g):
        return g, jnp.asarray(False)

    g, looped = jax.lax.cond(has_cand, close_loop, no_loop, g)

    # optimize after every keyframe; each GN iteration is a dense [3K, 3K]
    # solve — the dominant keyframe-event cost at K=256 (PERF.md), so
    # the iteration budget is config (and may differ when a closure landed)
    if gcfg.optimize_iterations_loop != gcfg.optimize_iterations:
        g = jax.lax.cond(
            looped,
            lambda gg: posegraph.optimize(
                gg, iterations=gcfg.optimize_iterations_loop,
                anchor_weight=1e6, huber_delta=gcfg.huber_delta),
            lambda gg: posegraph.optimize(
                gg, iterations=gcfg.optimize_iterations,
                anchor_weight=1e6, huber_delta=gcfg.huber_delta),
            g)
    else:
        g = posegraph.optimize(g, iterations=gcfg.optimize_iterations,
                               anchor_weight=1e6,
                               huber_delta=gcfg.huber_delta)

    new_state = state._replace(graph=g, kf_points=kf_points, kf_valid=kf_valid,
                               last_kf_pose=pose,
                               loop_count=state.loop_count + looped)
    return new_state, looped


def update(state: GraphSlamState, scan: Scan, hcfg: HectorConfig,
           gcfg: PoseGraphConfig,
           mcfg: frontend.ScanMatchConfig | None = None,
           map_without_matching=False) -> Tuple[GraphSlamState, GraphSlamInfo]:
    if mcfg is None:
        mcfg = frontend.ScanMatchConfig()

    hstate, hinfo = hector.update(state.hector, scan, state.hector.match_pose,
                                  hcfg, map_without_matching)
    pose = hstate.match_pose

    due = frontend.keyframe_due(state.last_kf_pose, pose, gcfg.keyframe_dist,
                                gcfg.keyframe_angle)

    def with_kf(st):
        st2, looped = _spawn_keyframe(st._replace(hector=hstate), scan, pose,
                                      gcfg, mcfg)
        # re-anchor the live matcher to the optimized current keyframe
        opt_pose = st2.graph.poses[st2.graph.num_nodes - 1]
        h = st2.hector._replace(match_pose=opt_pose.at[2].set(
            normalize_angle(opt_pose[2])))
        return st2._replace(hector=h), looped

    def without_kf(st):
        return st._replace(hector=hstate), jnp.asarray(False)

    new_state, looped = jax.lax.cond(due, with_kf, without_kf, state)
    return new_state, GraphSlamInfo(keyframe_added=due, loop_closed=looped,
                                    map_updated=hinfo.map_updated)


def rebuild_maps_sharded(mesh, state: GraphSlamState, hcfg: HectorConfig,
                         tile_axis: str = "tile",
                         search_axis: str = "search") -> jnp.ndarray:
    """Distributed map finalization (north star: "keyframes sharded across
    hosts"): keyframe CLOUD STORAGE is sharded over `search_axis` (each host
    keeps K/S clouds) and the pyramid's rows over `tile_axis`.  The rebuild
    walks keyframe slots in order; at each step the owning shard broadcasts its
    cloud with one psum (everyone else contributes zeros) and every tile
    applies the bitwise-exact row-local occupancy update
    (models/hector_sharded._level_update_local).  Result equals the serial
    rebuild_maps exactly (tests/test_graph_slam.py).

    Returns the stacked tile-local tables f32[T, local_cells] (halos
    refreshed), directly usable as a hector_sharded state; use
    hector_sharded.unshard_maps-style reassembly for a dense pyramid.
    """
    import jax.sharding as jsh
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from . import hector_sharded

    n_tiles = mesh.shape[tile_axis]
    n_search = mesh.shape[search_axis]
    kf_k = state.kf_points.shape[0]
    assert kf_k % n_search == 0, (kf_k, n_search)
    per = kf_k // n_search
    loffs = hector_sharded.local_level_offsets(hcfg, n_tiles)
    lrows = hector_sharded.level_rows(hcfg, n_tiles)
    ncells = hector_sharded.local_cells(hcfg, n_tiles)

    def local(kf_pts, kf_valid, poses, node_valid):
        # kf_pts arrives as this shard's [K/S, N, 2] cloud slice
        srank = jax.lax.axis_index(search_axis)
        tile = jax.lax.axis_index(tile_axis)

        def body(k, loc):
            owner = k // per
            kloc = jnp.where(owner == srank, k - owner * per, 0)
            pts = jnp.where(owner == srank,
                            jax.lax.dynamic_index_in_dim(kf_pts, kloc, 0,
                                                         keepdims=False), 0.0)
            vmask = jnp.where(owner == srank,
                              jax.lax.dynamic_index_in_dim(
                                  kf_valid, kloc, 0,
                                  keepdims=False).astype(jnp.int32), 0)
            # broadcast the owner's cloud: everyone else contributed zeros
            pts = jax.lax.psum(pts, search_axis)
            vmask = jax.lax.psum(vmask, search_axis)
            v = (vmask > 0) & node_valid[k]
            new = loc
            for level in range(hcfg.num_levels):
                width = hcfg.level_sizes[level]
                rows = lrows[level]
                new = hector_sharded._level_update_local(
                    new, loffs[level], width, rows, tile * rows, width,
                    pts[:, 0], pts[:, 1], v, poses[k],
                    1.0 / hcfg.level_resolutions[level], hcfg.log_odds_free,
                    hcfg.log_odds_occupied, hcfg.occupied_cap, search_axis)
            return new

        loc = jax.lax.fori_loop(0, kf_k, body,
                                jnp.zeros((ncells,), jnp.float32))
        for level in range(hcfg.num_levels):
            width = hcfg.level_sizes[level]
            loc = hector_sharded._halo_refresh_local(
                loc, loffs[level], width, lrows[level], tile_axis)
        return loc[None]

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(search_axis), P(search_axis), P(), P()),
                   out_specs=P(tile_axis), check_vma=False)
    return fn(state.kf_points, state.kf_valid, state.graph.poses,
              state.graph.node_valid)


def rebuild_maps(state: GraphSlamState, hcfg: HectorConfig) -> jnp.ndarray:
    """Offline map finalization: rasterize every stored keyframe scan at its
    OPTIMIZED pose into a fresh pyramid (lax.scan over keyframe slots)."""
    empty = jnp.zeros((hcfg.total_cells,), jnp.float32)

    def body(maps, inp):
        pts, valid, pose, is_kf = inp
        cloud = Scan(pts, valid & is_kf, jnp.zeros(3, jnp.float32))
        new = hector.update_maps(maps, cloud, pose, hcfg)
        return jnp.where(is_kf, new, maps), None

    maps, _ = jax.lax.scan(body, empty,
                           (state.kf_points, state.kf_valid, state.graph.poses,
                            state.graph.node_valid))
    return maps
