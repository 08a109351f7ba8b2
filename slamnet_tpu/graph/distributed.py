"""Distributed pose-graph Gauss-Newton: edge-sharded normal equations.

The multi-host solve of BASELINE.json's north star: constraint edges are sharded
over a mesh axis; every device accumulates the dense (H, b) contribution of its
edge shard and the partials psum across devices; the (small, dense) solve is
replicated.
Semantically identical to posegraph.gn_step (tests assert equality on the
8-device CPU mesh).

For graphs too large for a replicated dense solve, ``posegraph.solve_schur``
eliminates interior nodes per shard so only separator blocks cross hosts — the
Schur-complement reduction pattern.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core.geometry import normalize_angle
from . import posegraph


def _dense_contribution(poses, k, edge_i, edge_j, edge_meas, edge_w, edge_valid):
    r, ji, jj = posegraph.edge_residuals_and_jacobians(
        poses, edge_i, edge_j, edge_meas, edge_valid)
    w = edge_w * edge_valid[:, None]

    def blocks(ja, jb):
        return jnp.einsum("eri,er,erj->eij", ja, w, jb)

    H = jnp.zeros((k, 3, k, 3), jnp.float32)
    H = H.at[edge_i, :, edge_i, :].add(blocks(ji, ji))
    H = H.at[edge_i, :, edge_j, :].add(blocks(ji, jj))
    H = H.at[edge_j, :, edge_i, :].add(
        jnp.swapaxes(blocks(ji, jj), 1, 2))
    H = H.at[edge_j, :, edge_j, :].add(blocks(jj, jj))
    b = jnp.zeros((k, 3), jnp.float32)
    b = b.at[edge_i].add(jnp.einsum("eri,er,er->ei", ji, w, r))
    b = b.at[edge_j].add(jnp.einsum("eri,er,er->ei", jj, w, r))
    return H.reshape(3 * k, 3 * k), b.reshape(3 * k)


def sharded_gn_step(mesh: Mesh, g: posegraph.PoseGraph,
                    anchor_weight: float = 1e6, damping: float = 1e-6,
                    axis: str = "edge") -> posegraph.PoseGraph:
    """One GN step with the edge arrays sharded over `axis` (E divisible)."""
    k = g.poses.shape[0]

    def local(poses, node_valid, ei, ej, em, ew, ev):
        H, b = _dense_contribution(poses, k, ei, ej, em, ew, ev)
        H = jax.lax.psum(H, axis)
        b = jax.lax.psum(b, axis)
        diag = jnp.ones(3 * k, jnp.float32) * damping
        diag = diag.at[:3].add(anchor_weight)
        invalid = jnp.repeat(~node_valid, 3)
        diag = jnp.where(invalid, 1.0, diag)
        H = H + jnp.diag(diag)
        dx = jnp.linalg.solve(H, -b).reshape(k, 3)
        dx = jnp.where(node_valid[:, None], dx, 0.0)
        poses = poses + dx
        return poses.at[:, 2].set(normalize_angle(poses[:, 2]))

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis),
                             P(axis)),
                   out_specs=P())
    poses = fn(g.poses, g.node_valid, g.edge_i, g.edge_j, g.edge_meas,
               g.edge_w, g.edge_valid)
    return g._replace(poses=poses)


def sharded_optimize(mesh: Mesh, g: posegraph.PoseGraph, iterations: int = 10,
                     anchor_weight: float = 1e6, damping: float = 1e-6,
                     axis: str = "edge") -> posegraph.PoseGraph:
    for _ in range(iterations):
        g = sharded_gn_step(mesh, g, anchor_weight, damping, axis)
    return g
