"""Keyframe pose graph with Gauss-Newton optimization — greenfield layer.

No counterpart in the reference (SURVEY.md §2: "no loop closure, no pose graph");
required by BASELINE.json's north star: keyframes + loop-closure constraints
solved by distributed Gauss-Newton with Schur-complement reduction over
collectives.

Design (accelerator-first):
- fixed-capacity arrays: K node slots, E edge slots, validity masks (static
  shapes; adding a node/edge is a functional write at a counter index);
- SE(2) relative-pose residuals with analytic Jacobians;
- the normal equations are built DENSE: H is [3K, 3K] — for K <= a few thousand
  this is exactly the regime where one dense solve on the accelerator beats
  sparse scalar code;
- per-edge J^T W J contributions are scattered into H as 3x3 blocks; across
  devices the edge axis shards and the dense partials psum across devices
  (graph/distributed.py);
- gauge freedom fixed by a strong prior on node 0;
- optional Schur-complement elimination of a node partition (solve_schur) —
  the building block for multi-host reduction where interior nodes are
  eliminated locally and only separator blocks are exchanged.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..core.geometry import normalize_angle, rot2


class PoseGraph(NamedTuple):
    poses: jnp.ndarray       # f32[K, 3] current node estimates (world)
    node_valid: jnp.ndarray  # bool[K]
    num_nodes: jnp.ndarray   # i32[]
    edge_i: jnp.ndarray      # i32[E] from-node
    edge_j: jnp.ndarray      # i32[E] to-node
    edge_meas: jnp.ndarray   # f32[E, 3] measured relative pose (i -> j, in i's frame)
    edge_w: jnp.ndarray      # f32[E, 3] diagonal information (wx, wy, wth)
    edge_valid: jnp.ndarray  # bool[E]
    num_edges: jnp.ndarray   # i32[]


def init(max_nodes: int, max_edges: int) -> PoseGraph:
    return PoseGraph(
        poses=jnp.zeros((max_nodes, 3), jnp.float32),
        node_valid=jnp.zeros(max_nodes, bool),
        num_nodes=jnp.zeros((), jnp.int32),
        edge_i=jnp.zeros(max_edges, jnp.int32),
        edge_j=jnp.zeros(max_edges, jnp.int32),
        edge_meas=jnp.zeros((max_edges, 3), jnp.float32),
        edge_w=jnp.ones((max_edges, 3), jnp.float32),
        edge_valid=jnp.zeros(max_edges, bool),
        num_edges=jnp.zeros((), jnp.int32),
    )


def has_node_room(g: PoseGraph) -> jnp.ndarray:
    """True while another keyframe node fits (guard for callers that would
    otherwise wire edges to a clamped index when the graph is full)."""
    return g.num_nodes < g.poses.shape[0]


def add_node(g: PoseGraph, pose) -> Tuple[PoseGraph, jnp.ndarray]:
    """Append a keyframe node (no-op when full); returns (graph, node index).

    The returned index is CLAMPED to the last slot when the graph is full —
    never out of range — so downstream gathers stay in bounds; callers that add
    edges must additionally gate on has_node_room (models/graph_slam.py does)."""
    idx = g.num_nodes
    ok = idx < g.poses.shape[0]
    safe = jnp.minimum(idx, g.poses.shape[0] - 1)
    return g._replace(
        poses=g.poses.at[safe].set(jnp.where(ok, jnp.asarray(pose, jnp.float32),
                                             g.poses[safe])),
        node_valid=g.node_valid.at[safe].set(g.node_valid[safe] | ok),
        num_nodes=jnp.where(ok, idx + 1, idx),
    ), safe


def add_edge(g: PoseGraph, i, j, meas, weights=(1.0, 1.0, 1.0),
             enable=True) -> PoseGraph:
    """Append a relative-pose constraint i -> j (no-op when full or when
    `enable` is traced False — the capacity-guard hook)."""
    e = g.num_edges
    ok = (e < g.edge_i.shape[0]) & jnp.asarray(enable)
    safe = jnp.minimum(e, g.edge_i.shape[0] - 1)
    sel = lambda new, old: jnp.where(ok, new, old)
    return g._replace(
        edge_i=g.edge_i.at[safe].set(sel(jnp.asarray(i, jnp.int32),
                                         g.edge_i[safe])),
        edge_j=g.edge_j.at[safe].set(sel(jnp.asarray(j, jnp.int32),
                                         g.edge_j[safe])),
        edge_meas=g.edge_meas.at[safe].set(sel(jnp.asarray(meas, jnp.float32),
                                               g.edge_meas[safe])),
        edge_w=g.edge_w.at[safe].set(sel(jnp.asarray(weights, jnp.float32),
                                         g.edge_w[safe])),
        edge_valid=g.edge_valid.at[safe].set(g.edge_valid[safe] | ok),
        num_edges=jnp.where(ok, e + 1, e),
    )


def edge_residuals_and_jacobians(poses, edge_i, edge_j, edge_meas, edge_valid):
    """Residual r = [R_i^T (t_j - t_i) - t_m ; wrap(th_j - th_i - th_m)] per edge
    and analytic Jacobians wrt node i and node j.

    Returns (r f32[E,3], Ji f32[E,3,3], Jj f32[E,3,3]) — zeroed where invalid.
    """
    xi = poses[edge_i]            # [E, 3]
    xj = poses[edge_j]
    th = xi[:, 2]
    c, s = jnp.cos(th), jnp.sin(th)
    dt = xj[:, :2] - xi[:, :2]
    # R_i^T dt
    lx = c * dt[:, 0] + s * dt[:, 1]
    ly = -s * dt[:, 0] + c * dt[:, 1]
    r = jnp.stack([lx - edge_meas[:, 0], ly - edge_meas[:, 1],
                   normalize_angle(xj[:, 2] - xi[:, 2] - edge_meas[:, 2])], 1)

    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    # d r / d xi
    ji = jnp.stack([
        jnp.stack([-c, -s, -s * dt[:, 0] + c * dt[:, 1]], 1),
        jnp.stack([s, -c, -c * dt[:, 0] - s * dt[:, 1]], 1),
        jnp.stack([zero, zero, -one], 1),
    ], 1)                          # [E, 3, 3]
    # d r / d xj
    jj = jnp.stack([
        jnp.stack([c, s, zero], 1),
        jnp.stack([-s, c, zero], 1),
        jnp.stack([zero, zero, one], 1),
    ], 1)

    m = edge_valid[:, None]
    r = jnp.where(m, r, 0.0)
    ji = jnp.where(edge_valid[:, None, None], ji, 0.0)
    jj = jnp.where(edge_valid[:, None, None], jj, 0.0)
    return r, ji, jj


def robust_scale(r: jnp.ndarray, w: jnp.ndarray, delta: float,
                 kernel: str) -> jnp.ndarray:
    """Per-edge IRLS information scale for robust kernels.

    'huber': min(1, delta/e) with e = sqrt(r^T W r) — bounds but never rejects
    an outlier (its pull saturates at delta).
    'dcs': dynamic covariance scaling (Agarwal et al. 2013),
    s = (min(1, 2 delta^2 / (delta^2 + chi2)))^2 — REDESCENDING: influence of a
    gross outlier (false loop) goes to zero, which is what perceptual-aliasing
    rejection actually needs."""
    chi2 = jnp.maximum(jnp.sum(r * r * w, axis=1), 1e-12)
    if kernel == "huber":
        return jnp.minimum(1.0, delta / jnp.sqrt(chi2))
    if kernel == "dcs":
        s = jnp.minimum(1.0, 2.0 * delta * delta / (delta * delta + chi2))
        return s * s
    raise ValueError(f"unknown robust kernel {kernel!r}")


def build_normal_equations(g: PoseGraph, anchor_weight: float = 1e6,
                           damping: float = 1e-6, huber_delta: float = 0.0,
                           robust_kernel: str = "dcs",
                           active_k: int | None = None):
    """Dense (H [3K,3K], b [3K]) from all valid edges + node-0 gauge prior.

    huber_delta > 0 enables robust IRLS weighting with `robust_kernel`
    ('dcs' default, or 'huber'): an edge whose whitened residual exceeds the
    scale loses influence instead of bending the whole trajectory.

    active_k (static) assembles H/b at [3*active_k, 3*active_k] instead of
    full capacity — valid when num_nodes <= active_k (nodes are allocated in
    order, valid edges only reference valid nodes, invalid edge slots carry
    zero weight and index 0).  The assembly's zeros-init + block scatters
    scale with the STATIC size, so gn_step buckets it (PERF.md round 4)."""
    k = g.poses.shape[0] if active_k is None else active_k
    r, ji, jj = edge_residuals_and_jacobians(g.poses, g.edge_i, g.edge_j,
                                             g.edge_meas, g.edge_valid)
    w = g.edge_w * g.edge_valid[:, None]            # [E, 3]
    if huber_delta > 0.0:
        w = w * robust_scale(r, w, huber_delta, robust_kernel)[:, None]

    def blocks(ja, jb):
        #  ja^T W jb  per edge -> [E, 3, 3]
        return jnp.einsum("eri,er,erj->eij", ja, w, jb)

    hii = blocks(ji, ji)
    hij = blocks(ji, jj)
    hjj = blocks(jj, jj)
    bi = jnp.einsum("eri,er,er->ei", ji, w, r)
    bj = jnp.einsum("eri,er,er->ei", jj, w, r)

    H = jnp.zeros((k, 3, k, 3), jnp.float32)
    H = H.at[g.edge_i, :, g.edge_i, :].add(hii)
    H = H.at[g.edge_i, :, g.edge_j, :].add(hij)
    H = H.at[g.edge_j, :, g.edge_i, :].add(jnp.swapaxes(hij, 1, 2))
    H = H.at[g.edge_j, :, g.edge_j, :].add(hjj)
    b = jnp.zeros((k, 3), jnp.float32)
    b = b.at[g.edge_i].add(bi)
    b = b.at[g.edge_j].add(bj)

    H = H.reshape(3 * k, 3 * k)
    b = b.reshape(3 * k)
    # gauge prior on node 0 + LM damping; invalid nodes get identity rows
    diag = jnp.ones(3 * k, jnp.float32) * damping
    diag = diag.at[:3].add(anchor_weight)
    invalid = jnp.repeat(~g.node_valid[:k], 3)
    diag = jnp.where(invalid, 1.0, diag)
    H = H + jnp.diag(diag)
    return H, b


def _size_buckets(k: int) -> list:
    buckets, n = [], 32
    while n < k:
        buckets.append(n)
        n *= 2
    buckets.append(k)
    return buckets


def _active_gn_dx(g: PoseGraph, anchor_weight: float, damping: float,
                  huber_delta: float) -> jnp.ndarray:
    """dx [3K] of one GN step, paying only for the ACTIVE node prefix.

    Nodes are allocated in order, edges only couple valid nodes, and invalid
    rows carry an identity diagonal with zero b — so H is block-diagonal
    between the active prefix and the rest, and building + solving the
    top-left block alone is EXACT (the full solve's trailing dx is zero).
    Both costs scale with the STATIC capacity: the dense LU and the
    assembly's zeros-init + block scatters touch [3K, 3K] memory (measured
    as the dominant graph-SLAM keyframe cost before this change).  A lax.switch over power-of-two bucket sizes makes
    both pay for the graph that actually exists; num_nodes is traced,
    buckets are static."""
    k = g.poses.shape[0]
    buckets = _size_buckets(k)

    def branch(n):
        def f(_):
            H, b = build_normal_equations(g, anchor_weight, damping,
                                          huber_delta, active_k=n)
            dx = jnp.linalg.solve(H, -b)
            if n == k:
                return dx
            return jnp.concatenate([dx, jnp.zeros(3 * (k - n), dx.dtype)])
        return f

    if len(buckets) == 1:
        return branch(k)(None)
    # index of the smallest bucket >= num_nodes
    idx = jnp.int32(0)
    for n in buckets[:-1]:
        idx = idx + (jnp.asarray(g.num_nodes) > n).astype(jnp.int32)
    return jax.lax.switch(idx, [branch(n) for n in buckets], None)


def gn_step(g: PoseGraph, anchor_weight: float = 1e6,
            damping: float = 1e-6, huber_delta: float = 0.0) -> PoseGraph:
    """One Gauss-Newton step: solve H dx = -b, apply, re-wrap headings."""
    k = g.poses.shape[0]
    dx = _active_gn_dx(g, anchor_weight, damping, huber_delta).reshape(k, 3)
    dx = jnp.where(g.node_valid[:, None], dx, 0.0)
    poses = g.poses + dx
    poses = poses.at[:, 2].set(normalize_angle(poses[:, 2]))
    return g._replace(poses=poses)


def optimize(g: PoseGraph, iterations: int = 10, anchor_weight: float = 1e6,
             damping: float = 1e-6, huber_delta: float = 0.0) -> PoseGraph:
    def body(_, gg):
        return gn_step(gg, anchor_weight, damping, huber_delta)
    return jax.lax.fori_loop(0, iterations, body, g)


def total_error(g: PoseGraph) -> jnp.ndarray:
    r, _, _ = edge_residuals_and_jacobians(g.poses, g.edge_i, g.edge_j,
                                           g.edge_meas, g.edge_valid)
    return jnp.sum((r ** 2) * g.edge_w * g.edge_valid[:, None])


def solve_schur(H: jnp.ndarray, b: jnp.ndarray, n_keep: int) -> jnp.ndarray:
    """Solve H dx = -b by Schur elimination of the trailing block.

    Partition x = [x_a (3*n_keep); x_b]: eliminate x_b, solve the reduced system
    (A - B C^-1 B^T) x_a = -(b_a - B C^-1 b_b), back-substitute x_b.  Identical
    to the dense solve (tests assert this); the reduced system is what crosses
    hosts in the distributed solver — interior nodes never leave their shard.
    """
    na = 3 * n_keep
    A = H[:na, :na]
    B = H[:na, na:]
    C = H[na:, na:]
    ba, bb = b[:na], b[na:]
    Cinv_bt = jnp.linalg.solve(C, B.T)
    Cinv_bb = jnp.linalg.solve(C, bb)
    S = A - B @ Cinv_bt
    rhs = -(ba - B @ Cinv_bb)
    xa = jnp.linalg.solve(S, rhs)
    xb = jnp.linalg.solve(C, -bb - B.T @ xa)
    return jnp.concatenate([xa, xb])
