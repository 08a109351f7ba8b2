"""Beam-sharded Gauss-Newton accumulation — sequence parallelism over the scan.

The multi-device scaling of Hector's chunked (H, dTr) reduction
(ScanMatcher.cs:149-196): the reference splits beams across worker threads and
host-sums partials; here beams are sharded over the 'beam' mesh axis and the 3x3
Hessian + residual partials are psum'd across devices — the 2D-SLAM analogue of
sequence parallelism (SURVEY.md §5.7a).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import gn


def sharded_hessian_derivs(mesh: Mesh, logodds_flat: jnp.ndarray, width: int,
                           points: jnp.ndarray, valid: jnp.ndarray,
                           pose_px: jnp.ndarray, scale_to_map: float,
                           axis: str = "beam") -> Tuple[jnp.ndarray,
                                                        jnp.ndarray]:
    """(H, dTr) with the beam axis sharded over `axis`; map + pose replicated.

    points: f32[N, 2] with N divisible by the axis size.  Identical result to the
    dense ops.gn.hessian_derivs (psum of per-shard partial sums).
    """
    def local(logodds, points, valid, pose_px):
        h, dtr = gn.hessian_derivs(logodds, width, points, valid, pose_px,
                                   scale_to_map)
        return jax.lax.psum(h, axis), jax.lax.psum(dtr, axis)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(), P(axis), P(axis), P()),
                   out_specs=(P(), P()))
    return fn(logodds_flat, points, valid, pose_px)


def sharded_gn_iteration(mesh: Mesh, logodds_flat, width, points, valid,
                         pose_px, scale_to_map, deriv_clamp: float = 0.2,
                         axis: str = "beam"):
    """One beam-sharded GN step (solve is replicated — it is 3x3)."""
    H, dtr = sharded_hessian_derivs(mesh, logodds_flat, width, points, valid,
                                    pose_px, scale_to_map, axis)
    return pose_px + gn.solve_gn_step(H, dtr, deriv_clamp)
