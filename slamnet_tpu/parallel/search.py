"""Sharded Monte-Carlo candidate search — data parallelism over candidates.

The multi-device scaling of CoreSLAM's ParallelMonteCarloSearch
(CoreSLAMProcessor.cs:674-710): the reference forks N threads each scoring its own
candidate stream and the host argmin-reduces; here the candidate batch is sharded
over the 'search' mesh axis, every device scores its shard in the fused kernel,
and the global argmin is one (min, argmin-select) collective pair.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import score


def sharded_monte_carlo_search(mesh: Mesh, hole_map_flat: jnp.ndarray,
                               size: int, scale: float, points: jnp.ndarray,
                               valid: jnp.ndarray, search_pose: jnp.ndarray,
                               sigma_xy: float, sigma_theta: float,
                               num_candidates: int, key,
                               axis: str = "search") -> Tuple[jnp.ndarray,
                                                              jnp.ndarray]:
    """Like ops.score.monte_carlo_search but with candidates sharded over `axis`.

    Map + points replicated; candidates split n_shards ways; per-shard keys are
    folded from the shard index so the global candidate set is deterministic.
    Returns (best_pose f32[3], best_sum i32) — identical semantics to the
    single-device search over the same total candidate count.
    """
    n_shards = mesh.shape[axis]
    assert num_candidates % n_shards == 0, (num_candidates, n_shards)
    local_b = num_candidates // n_shards

    def local_search(hole_map, points, valid, search_pose, key):
        idx = jax.lax.axis_index(axis)
        sub = jax.random.fold_in(key, idx)
        kxy, kth = jax.random.split(sub)
        dxy = jax.random.normal(kxy, (local_b, 2)) * sigma_xy
        dth = jax.random.normal(kth, (local_b, 1)) * sigma_theta
        deltas = jnp.concatenate([dxy, dth], axis=1)
        # shard 0's first candidate is the unperturbed search pose
        deltas = jnp.where(idx == 0, deltas.at[0].set(0.0), deltas)
        cands = search_pose[None, :] + deltas

        sums, nb = score.score_candidates(hole_map, size, scale, points, valid,
                                          cands)
        eff = jnp.where(nb > 0, sums, score.INT32_MAX)
        li = jnp.argmin(eff)
        local_best = eff[li]
        local_pose = cands[li]

        # global argmin across devices: min-reduce the score, then broadcast the
        # owning shard's pose (first shard wins ties, like the host loop)
        gmin = jax.lax.pmin(local_best, axis)
        is_best = (local_best == gmin)
        first_best = jax.lax.pmin(
            jnp.where(is_best, idx, jnp.int32(n_shards)), axis)
        contrib = jnp.where(idx == first_best, local_pose, jnp.zeros(3))
        best_pose = jax.lax.psum(contrib, axis)
        return best_pose, gmin

    specs_in = (P(), P(), P(), P(), P())
    fn = shard_map(local_search, mesh=mesh, in_specs=specs_in,
                   out_specs=(P(), P()))
    return fn(hole_map_flat, points, valid, search_pose, key)
