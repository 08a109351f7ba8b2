"""Reference-API compatibility layer: OO wrappers mirroring slam.net's classes.

A user of the reference drives `CoreSLAMProcessor` / `HectorSLAMProcessor`
objects with `Update(...)` / `Reset()` calls and reads `Pose` / `MatchPose`
properties (CoreSLAM/CoreSLAMProcessor.cs:119-175,717; HectorSLAM/Main/
HectorSLAMProcessor.cs:66-138).  These thin stateful wrappers provide the same
surface over the functional core — each Update is one jitted device step;
state lives on device between calls.

The functional API (models/*) remains the primary interface; use it for
replay/fleet/sharded workloads.
"""
from __future__ import annotations

import math
import time as time_module
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .core.config import CoreSlamConfig, HectorConfig
from .core.scan import Scan, SegmentScan
from .io.metrics import EmaTimer
from .models import coreslam, hector


class CoreSLAMProcessor:
    """Mirror of CoreSLAM/CoreSLAMProcessor.cs's public surface."""

    def __init__(self, physical_map_size: float, hole_map_size: int,
                 obstacle_map_size: int, start_pose,
                 sigma_xy: float, sigma_theta: float,
                 iterations_per_thread: int = 1000,
                 num_search_threads: int = 4, *,
                 hole_width: float = 0.6, quality: int = 50, seed: int = 0):
        # threads x iterations becomes one candidate batch (SURVEY.md §2.5 P2)
        num_candidates = max(iterations_per_thread * max(num_search_threads, 1),
                             1)
        self.cfg = CoreSlamConfig(
            physical_map_size=physical_map_size, hole_map_size=hole_map_size,
            obstacle_map_size=obstacle_map_size, sigma_xy=sigma_xy,
            sigma_theta=sigma_theta, num_candidates=num_candidates,
            hole_width=hole_width, quality=quality)
        self._start_pose = np.asarray(start_pose, np.float32)
        self._seed = seed
        self.Reset()
        cfg = self.cfg
        self._step = jax.jit(
            lambda st, seg: coreslam.update(st, seg, cfg))

    def Reset(self) -> None:
        """CoreSLAMProcessor.Reset (:167-175)."""
        self.state = coreslam.init(self.cfg, self._start_pose,
                                   key=jax.random.PRNGKey(self._seed))

    def Update(self, segments: SegmentScan) -> None:
        """CoreSLAMProcessor.Update (:717-752); segments as a SegmentScan."""
        self.state, _ = self._step(self.state, segments)

    def Dispose(self) -> None:
        """IDisposable parity (CoreSLAMProcessor.cs:767-773).  The reference
        throws when constructed with numSearchThreads <= 0 (documented quirk,
        SURVEY.md §2.2) — knowingly fixed: always safe here."""
        self.state = None

    def _set_cfg(self, **kw):
        """Mutable-property parity (CoreSLAMProcessor.cs:80-101): knobs are
        trace-time constants, so a property write re-specializes the step."""
        import dataclasses
        self.cfg = dataclasses.replace(self.cfg, **kw)
        cfg = self.cfg
        self._step = jax.jit(lambda st, seg: coreslam.update(st, seg, cfg))

    @property
    def Quality(self) -> int:
        return self.cfg.quality

    @Quality.setter
    def Quality(self, v: int) -> None:
        self._set_cfg(quality=int(v))

    @property
    def HoleWidth(self) -> float:
        return self.cfg.hole_width

    @HoleWidth.setter
    def HoleWidth(self, v: float) -> None:
        self._set_cfg(hole_width=float(v))

    @property
    def PositionSearchBeginning(self) -> int:
        return self.cfg.position_search_beginning

    @PositionSearchBeginning.setter
    def PositionSearchBeginning(self, v: int) -> None:
        self._set_cfg(position_search_beginning=int(v))

    @property
    def UnmappedObstacleHits(self) -> int:
        return self.cfg.unmapped_obstacle_hits

    @UnmappedObstacleHits.setter
    def UnmappedObstacleHits(self, v: int) -> None:
        self._set_cfg(unmapped_obstacle_hits=int(v))

    @property
    def MaxObstacleHits(self) -> int:
        return self.cfg.max_obstacle_hits

    @MaxObstacleHits.setter
    def MaxObstacleHits(self, v: int) -> None:
        self._set_cfg(max_obstacle_hits=int(v))

    @property
    def Pose(self) -> np.ndarray:
        return np.asarray(self.state.pose)

    @property
    def HoleMap(self) -> np.ndarray:
        s = self.cfg.hole_map_size
        return np.asarray(self.state.hole_map).astype(np.uint16).reshape(s, s)

    @property
    def ObstacleMap(self) -> np.ndarray:
        return np.asarray(self.state.obstacle_map)


class HectorSLAMProcessor:
    """Mirror of HectorSLAM/Main/HectorSLAMProcessor.cs's public surface."""

    def __init__(self, map_resolution: float, map_size: int, start_pose,
                 num_depth: int = 4, num_threads: int = 4, logger=None, *,
                 min_distance_diff_for_map_update: float = 0.3,
                 min_angle_diff_for_map_update: float = 0.13,
                 estimate_iterations: Optional[Sequence[int]] = None,
                 matcher_mode: str = "gather"):
        del num_threads  # threads dissolve into the fused kernels
        iters = tuple(estimate_iterations) if estimate_iterations \
            else tuple([3] * num_depth)
        # matcher_mode: "gather" (reference-exact path) or
        # "onehot_highest"/"onehot_bf16"/"pallas" — the faster matchers
        # (PERF.md); no reference counterpart, exposed for users who
        # switch for throughput without leaving the OO surface.
        self.cfg = HectorConfig(
            map_resolution=map_resolution, map_size=map_size,
            num_levels=num_depth, estimate_iterations=iters,
            min_distance_diff_for_map_update=min_distance_diff_for_map_update,
            min_angle_diff_for_map_update=min_angle_diff_for_map_update,
            matcher_mode=matcher_mode)
        self._start_pose = np.asarray(start_pose, np.float32)
        self.logger = logger
        self.MatchTiming = EmaTimer()
        self.UpdateTiming = EmaTimer()
        self.Reset()
        cfg = self.cfg
        self._step = jax.jit(
            lambda st, scan, force: hector.update(
                st, scan, st.match_pose, cfg, map_without_matching=force))

    def Reset(self) -> None:
        self.state = hector.init(self.cfg, self._start_pose)

    def Dispose(self) -> None:
        self.state = None

    def _set_cfg(self, **kw):
        import dataclasses
        self.cfg = dataclasses.replace(self.cfg, **kw)
        cfg = self.cfg
        self._step = jax.jit(
            lambda st, scan, force: hector.update(
                st, scan, st.match_pose, cfg, map_without_matching=force))

    def SetUpdateFactorFree(self, v: float) -> None:
        """MapRepMultiMap.SetUpdateFactorFree broadcast (MapRepMultiMap.cs:83-88)."""
        self._set_cfg(update_factor_free=float(v))

    def SetUpdateFactorOccupied(self, v: float) -> None:
        """MapRepMultiMap.SetUpdateFactorOccupied (MapRepMultiMap.cs:90-95)."""
        self._set_cfg(update_factor_occupied=float(v))

    def Update(self, scan: Scan, pose_hint_world=None,
               map_without_matching: bool = False) -> bool:
        """HectorSLAMProcessor.Update (:86-126); returns map-updated flag.

        The reference times match and map-update separately (:92-96, :111-115);
        here both run in ONE fused device step, so MatchTiming tracks the full
        step and UpdateTiming tracks the steps where a map update actually
        fired (documented approximation of the split)."""
        with self.MatchTiming.time() as t:
            if pose_hint_world is not None:
                self.state = self.state._replace(
                    match_pose=jnp.asarray(pose_hint_world, jnp.float32))
            self.state, info = self._step(self.state, scan,
                                          jnp.asarray(map_without_matching))
            updated = bool(info.map_updated)
        if updated:
            self.UpdateTiming.update(time_module.perf_counter() - t.t0)
        if self.logger is not None:
            # parity with the reference's ILogger surface (ScanMatcher.cs:99-115)
            fails = int(info.solve_failures)
            if fails:
                self.logger.log(f"H is not invertible ({fails} GN steps)",
                                level="Information")
            if updated:
                self.logger.log(f"Map update at {self.MatchPose}")
        return updated

    @property
    def MatchPose(self) -> np.ndarray:
        return np.asarray(self.state.match_pose)

    @property
    def MapRep(self) -> List[np.ndarray]:
        """Per-level log-odds grids (MapRepMultiMap.Maps analogue)."""
        return [np.asarray(hector.level_view(self.state.maps, self.cfg, i))
                for i in range(self.cfg.num_levels)]

    def GetBitmapData(self, level: int = 0) -> np.ndarray:
        """GridMap.GetBitmapData (GridMap.cs:104-115)."""
        from .io import export
        s = self.cfg.level_sizes[level]
        return export.occupancy_bitmap(
            np.asarray(hector.level_view(self.state.maps, self.cfg, level))
            .reshape(-1), s)
