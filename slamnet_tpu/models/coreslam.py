"""CoreSLAM pipeline: functional state + one fused jitted step per scan.

The array-program equivalent of CoreSLAMProcessor (CoreSLAM/CoreSLAMProcessor.cs):
state is a pytree (maps + pose + counters + PRNG key); ``update`` is a pure
function (state, segments) -> (state', info), jitted once and replayed per scan.
The reference's 4-thread Monte-Carlo search with per-thread RNG queues
(CoreSLAMProcessor.cs:674-710, 599-612) becomes one vmapped candidate batch scored
in a fused kernel with jax.random keys split inside the jit — the RNG-prefill
pipeline (P5 in SURVEY.md §2.5) is unnecessary because key splitting is free.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..core.config import CoreSlamConfig
from ..core.geometry import normalize_angle
from ..core.scan import Scan, SegmentScan, segments_to_cloud
from ..ops import correlate, holemap, obstacle, score

HOLE_INIT = (holemap.TS_OBSTACLE + holemap.TS_NO_OBSTACLE) // 2  # 32750 (:169)


class CoreSlamState(NamedTuple):
    hole_map: jnp.ndarray       # i32[S*S] flat (HoleMap.cs stores flat ushort[])
    obstacle_map: jnp.ndarray   # i8[OS, OS]
    pose: jnp.ndarray           # f32[3]
    last_odometry: jnp.ndarray  # f32[3]
    scan_count: jnp.ndarray     # i32[] — counts scans until search warmup only
    key: jnp.ndarray            # PRNG key


class CoreSlamInfo(NamedTuple):
    searched: jnp.ndarray       # bool — did Monte-Carlo search run this scan?
    best_sum: jnp.ndarray       # i32 — best candidate's in-bounds pixel sum


def init(cfg: CoreSlamConfig, start_pose, key=None) -> CoreSlamState:
    """Reset semantics of CoreSLAMProcessor.Reset (CoreSLAMProcessor.cs:167-175)."""
    s = cfg.hole_map_size
    os_ = cfg.obstacle_map_size
    if key is None:
        key = jax.random.PRNGKey(0)
    return CoreSlamState(
        hole_map=jnp.full((s * s,), HOLE_INIT, jnp.int32),
        obstacle_map=jnp.full((os_, os_), cfg.unmapped_obstacle_hits, jnp.int8),
        pose=jnp.asarray(start_pose, jnp.float32),
        last_odometry=jnp.zeros(3, jnp.float32),
        scan_count=jnp.zeros((), jnp.int32),
        key=key,
    )


def reset(state: CoreSlamState, cfg: CoreSlamConfig, start_pose) -> CoreSlamState:
    return init(cfg, start_pose, key=state.key)


def update(state: CoreSlamState, segments: SegmentScan,
           cfg: CoreSlamConfig) -> Tuple[CoreSlamState, CoreSlamInfo]:
    """One scan: de-skew -> (warm? MC search : trust odometry) -> update both maps.

    Mirrors CoreSLAMProcessor.Update (CoreSLAMProcessor.cs:717-752): the search
    prior is the last pose plus the odometry delta (:728); during the first
    `position_search_beginning` scans the odometry pose is adopted directly
    (:739-743); heading is normalized (:746); both maps update at the NEW pose.
    """
    odo = segments.odometry_pose
    cloud = segments_to_cloud(segments)
    return _update_cloud(state, cloud, odo, cfg)


def _update_cloud(state: CoreSlamState, cloud: Scan, odo: jnp.ndarray,
                  cfg: CoreSlamConfig) -> Tuple[CoreSlamState, CoreSlamInfo]:
    key, sub = jax.random.split(state.key)
    search_pose = state.pose + (odo - state.last_odometry)
    warm = state.scan_count >= cfg.position_search_beginning

    def do_search(_):
        if cfg.search_mode == "correlative":
            span = cfg.corr_theta_span or 3.0 * cfg.sigma_theta
            best, best_sum = correlate.correlative_search(
                state.hole_map, cfg.hole_map_size, cfg.hole_scale,
                cloud.points, cloud.valid, search_pose,
                cfg.corr_window, cfg.corr_num_theta, span)
        else:
            best, best_sum = score.monte_carlo_search(
                state.hole_map, cfg.hole_map_size, cfg.hole_scale,
                cloud.points, cloud.valid, search_pose,
                cfg.sigma_xy, cfg.sigma_theta, cfg.num_candidates, sub)
        return best, best_sum

    def no_search(_):
        return odo, jnp.int32(0)

    new_pose, best_sum = jax.lax.cond(warm, do_search, no_search, None)
    new_pose = new_pose.at[2].set(normalize_angle(new_pose[2]))

    if cfg.dense_hole_fill:
        hole = holemap.update_hole_map_dense(
            state.hole_map, cfg.hole_map_size, cfg.hole_scale,
            cloud.points, cloud.valid, new_pose, cfg.hole_width, cfg.quality,
            cfg.angle_bins)
    else:
        hole = holemap.update_hole_map(
            state.hole_map, cfg.hole_map_size, cfg.hole_scale,
            cloud.points, cloud.valid, new_pose, cfg.hole_width, cfg.quality)
    if cfg.dense_obstacle_fill:
        obst = obstacle.update_obstacle_map_dense(
            state.obstacle_map, cfg.obstacle_map_size, cfg.obstacle_scale,
            cloud.points, cloud.valid, new_pose, cfg.max_obstacle_hits,
            cfg.angle_bins)
    else:
        obst = obstacle.update_obstacle_map(
            state.obstacle_map, cfg.obstacle_map_size, cfg.obstacle_scale,
            cloud.points, cloud.valid, new_pose, cfg.max_obstacle_hits)

    new_state = CoreSlamState(
        hole_map=hole,
        obstacle_map=obst,
        pose=new_pose,
        last_odometry=odo,
        scan_count=jnp.where(warm, state.scan_count, state.scan_count + 1),
        key=key,
    )
    return new_state, CoreSlamInfo(searched=warm, best_sum=best_sum)


def update_cloud(state: CoreSlamState, cloud: Scan, odometry_pose,
                 cfg: CoreSlamConfig) -> Tuple[CoreSlamState, CoreSlamInfo]:
    """Update from an already-deskewed cloud (single-segment fast path)."""
    return _update_cloud(state, cloud, jnp.asarray(odometry_pose, jnp.float32), cfg)
