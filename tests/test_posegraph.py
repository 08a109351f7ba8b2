"""Pose-graph layer: GN recovers noisy trajectories, Schur == dense, sharded ==
single-device, frontend scan matching recovers known offsets."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slamnet_tpu.core.geometry import pose_between, pose_compose
from slamnet_tpu.core.scan import Scan
from slamnet_tpu.graph import distributed, frontend, posegraph
from slamnet_tpu.parallel import make_mesh


def _circle_graph(n=24, radius=5.0, odo_noise=0.03, seed=0, max_nodes=32,
                  max_edges=64):
    """Ground-truth circle; odometry edges with noise + a few exact closures."""
    rng = np.random.default_rng(seed)
    ths = np.linspace(0, 2 * math.pi, n, endpoint=False)
    truth = np.stack([radius * np.cos(ths), radius * np.sin(ths),
                      ths + math.pi / 2], -1).astype(np.float32)

    g = posegraph.init(max_nodes, max_edges)
    # initialize nodes with DRIFTED poses integrated from noisy odometry
    est = truth[0].copy()
    g, _ = posegraph.add_node(g, est)
    ests = [est.copy()]
    for t in range(1, n):
        rel = np.asarray(pose_between(jnp.asarray(truth[t - 1]),
                                      jnp.asarray(truth[t])))
        noisy = rel + rng.normal(0, odo_noise, 3).astype(np.float32)
        est = np.asarray(pose_compose(jnp.asarray(est), jnp.asarray(noisy)))
        g, _ = posegraph.add_node(g, est)
        ests.append(est.copy())
        g = posegraph.add_edge(g, t - 1, t, noisy, (10.0, 10.0, 40.0))
    # exact loop closures: 0->n/2 and n-1->0
    rel = np.asarray(pose_between(jnp.asarray(truth[0]),
                                  jnp.asarray(truth[n // 2])))
    g = posegraph.add_edge(g, 0, n // 2, rel, (100.0, 100.0, 400.0))
    rel = np.asarray(pose_between(jnp.asarray(truth[n - 1]),
                                  jnp.asarray(truth[0])))
    g = posegraph.add_edge(g, n - 1, 0, rel, (100.0, 100.0, 400.0))
    return g, truth, np.asarray(ests)


def test_gn_reduces_error_and_recovers_circle():
    g, truth, ests = _circle_graph()
    e0 = float(posegraph.total_error(g))
    opt = posegraph.optimize(g, iterations=15)
    e1 = float(posegraph.total_error(opt))
    assert e1 < e0 * 0.2, (e0, e1)
    n = truth.shape[0]
    before = np.linalg.norm(ests[:, :2] - truth[:, :2], axis=1)
    after = np.linalg.norm(np.asarray(opt.poses[:n, :2]) - truth[:, :2], axis=1)
    # drift reduced (node 0 anchored at its initial = true pose)
    assert after.mean() < before.mean()
    assert after.max() < 0.35, after.max()


def test_huber_downweights_outlier_edge():
    # a grossly wrong loop edge: plain GN bends the circle toward it; Huber
    # weighting keeps the recovered trajectory near the truth
    g, truth, _ = _circle_graph()
    n = truth.shape[0]
    bogus = np.asarray([4.0, -4.0, 1.5], np.float32)   # nonsense constraint
    g = posegraph.add_edge(g, 2, n // 2 + 2, bogus, (100.0, 100.0, 400.0))

    plain = posegraph.optimize(g, iterations=15)
    robust = posegraph.optimize(g, iterations=15, huber_delta=3.0)
    err_plain = np.linalg.norm(
        np.asarray(plain.poses[:n, :2]) - truth[:, :2], axis=1)
    err_robust = np.linalg.norm(
        np.asarray(robust.poses[:n, :2]) - truth[:, :2], axis=1)
    assert err_robust.mean() < err_plain.mean() * 0.7, \
        (err_plain.mean(), err_robust.mean())
    assert err_robust.max() < 0.6, err_robust.max()


def test_add_node_full_returns_clamped_index():
    g = posegraph.init(2, 4)
    g, i0 = posegraph.add_node(g, (0.0, 0.0, 0.0))
    g, i1 = posegraph.add_node(g, (1.0, 0.0, 0.0))
    assert not bool(posegraph.has_node_room(g))
    g2, i2 = posegraph.add_node(g, (9.0, 9.0, 9.0))   # full: no-op
    assert int(i2) == 1                                # clamped, in range
    assert int(g2.num_nodes) == 2
    np.testing.assert_array_equal(np.asarray(g2.poses), np.asarray(g.poses))
    # gated edge add is a no-op
    g3 = posegraph.add_edge(g2, 0, int(i2), (0.0, 0.0, 0.0), enable=False)
    assert int(g3.num_edges) == 0


def test_schur_solve_equals_dense():
    g, _, _ = _circle_graph()
    H, b = posegraph.build_normal_equations(g)
    dense = np.asarray(jnp.linalg.solve(H, -b))
    schur = np.asarray(posegraph.solve_schur(H, b, n_keep=10))
    np.testing.assert_allclose(schur, dense, rtol=2e-3, atol=2e-4)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_schur_node_sharded_equals_dense():
    # >= 128-node graph with loop closures; nodes sharded 8 ways; interiors
    # eliminated locally, only the packed separator system crosses shards
    from slamnet_tpu.graph import schur
    g, truth, _ = _circle_graph(n=128, max_nodes=128, max_edges=256)
    mesh = make_mesh({"node": 8})
    assert schur.check_separator_capacity(g, 8, sep_capacity=8)
    dense = posegraph.gn_step(g)
    shard, overflow = schur.schur_gn_step(mesh, g, sep_capacity=8)
    assert int(overflow) == 0
    np.testing.assert_allclose(np.asarray(shard.poses),
                               np.asarray(dense.poses), rtol=2e-4, atol=2e-4)
    # a second chained step stays in agreement (covers back-substitution
    # feeding the next linearization; full-optimize equality follows by
    # induction and is skipped to keep CI compile time bounded)
    dense2 = posegraph.gn_step(dense)
    shard2, _ = schur.schur_gn_step(mesh, shard, sep_capacity=8)
    np.testing.assert_allclose(np.asarray(shard2.poses),
                               np.asarray(dense2.poses), rtol=5e-4, atol=5e-4)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_separator_overflow_is_loud():
    # a dense loop-closure cluster: every node in shard 0 gets a cross edge,
    # exceeding sep_capacity=2 — the step must REPORT the overflow, matching
    # the host-side capacity check, instead of silently converging wrong
    from slamnet_tpu.graph import schur
    g, truth, _ = _circle_graph(n=64, max_nodes=64, max_edges=256)
    m = 64 // 8
    for t in range(m):                      # shard 0 node t <-> shard 4 node
        rel = np.asarray(pose_between(jnp.asarray(truth[t]),
                                      jnp.asarray(truth[t + 4 * m])))
        g = posegraph.add_edge(g, t, t + 4 * m, rel, (10.0, 10.0, 40.0))
    mesh = make_mesh({"node": 8})
    assert not schur.check_separator_capacity(g, 8, sep_capacity=2)
    _, overflow = schur.schur_gn_step(mesh, g, sep_capacity=2)
    assert int(overflow) > 0
    # with enough slots the same graph reports clean and matches dense
    assert schur.check_separator_capacity(g, 8, sep_capacity=16)
    shard, ok_overflow = schur.schur_gn_step(mesh, g, sep_capacity=16)
    assert int(ok_overflow) == 0
    dense = posegraph.gn_step(g)
    np.testing.assert_allclose(np.asarray(shard.poses),
                               np.asarray(dense.poses), rtol=2e-3, atol=2e-3)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_gn_equals_dense():
    g, _, _ = _circle_graph(max_edges=64)   # 64 edges / 8 devices
    mesh = make_mesh({"edge": 8})
    single = posegraph.gn_step(g)
    shard = distributed.sharded_gn_step(mesh, g)
    np.testing.assert_allclose(np.asarray(shard.poses),
                               np.asarray(single.poses), rtol=1e-4, atol=1e-4)


def _ring_scan(center_offset, n=256, radius=6.0, seed=3):
    """Points of a square room seen from a pose offset inside it."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    # square room half-size `radius`: distance to wall along each ray
    cx, cy, cth = center_offset
    d = np.full(n, np.inf)
    for wall, axis, sign in ((radius, 0, 1), (-radius, 0, -1),
                             (radius, 1, 1), (-radius, 1, -1)):
        dirv = np.stack([np.cos(ang + cth), np.sin(ang + cth)], -1)
        denom = dirv[:, axis]
        t = (wall - (cx if axis == 0 else cy)) / np.where(
            np.abs(denom) < 1e-9, 1e-9, denom)
        t = np.where(t > 0, t, np.inf)
        d = np.minimum(d, t)
    d = np.clip(d, 0, 30.0)
    pts = np.stack([d * np.cos(ang), d * np.sin(ang)], -1).astype(np.float32)
    return Scan(jnp.asarray(pts), jnp.ones(n, bool), jnp.zeros(3, jnp.float32))


def test_match_scans_recovers_relative_pose():
    cfg = frontend.ScanMatchConfig()
    ref = _ring_scan((0.0, 0.0, 0.0))
    true_rel = np.asarray([0.4, -0.3, 0.08], np.float32)
    qry = _ring_scan(tuple(true_rel))
    rel, q = frontend.match_scans(ref, qry, (0.0, 0.0, 0.0), cfg)
    err = np.asarray(rel) - true_rel
    assert abs(err[0]) < 0.1 and abs(err[1]) < 0.1, rel
    assert abs(err[2]) < 0.05
    # a correct match lands most points on the reference's occupied cells;
    # a garbage query against the same grid lands almost none
    assert float(q.inlier_frac) > 0.5, float(q.inlier_frac)
    rng = np.random.default_rng(11)
    junk = Scan(jnp.asarray(rng.uniform(-8, 8, (256, 2)), jnp.float32),
                jnp.ones(256, bool), jnp.zeros(3, jnp.float32))
    _, qj = frontend.match_scans(ref, junk, (0.0, 0.0, 0.0), cfg)
    assert float(qj.inlier_frac) < 0.25, float(qj.inlier_frac)


def test_match_scans_production_modes():
    # onehot_highest: one-hot row matmuls select grid entries exactly, so the
    # match is BIT-identical to the gather matcher; dense_fill + onehot_bf16
    # (the production loop-closure path) must still recover the relative pose
    # and separate real matches from junk.
    ref = _ring_scan((0.0, 0.0, 0.0))
    true_rel = np.asarray([0.4, -0.3, 0.08], np.float32)
    qry = _ring_scan(tuple(true_rel))

    rel_g, qg = frontend.match_scans(ref, qry, (0.0, 0.0, 0.0),
                                     frontend.ScanMatchConfig())
    rel_oh, qoh = frontend.match_scans(
        ref, qry, (0.0, 0.0, 0.0),
        frontend.ScanMatchConfig(matcher_mode="onehot_highest"))
    np.testing.assert_array_equal(np.asarray(rel_oh), np.asarray(rel_g))
    np.testing.assert_array_equal(float(qoh.inlier_frac),
                                  float(qg.inlier_frac))

    prod = frontend.ScanMatchConfig(matcher_mode="onehot_bf16",
                                    dense_fill=True)
    rel_p, qp = frontend.match_scans(ref, qry, (0.0, 0.0, 0.0), prod)
    err = np.asarray(rel_p) - true_rel
    assert abs(err[0]) < 0.1 and abs(err[1]) < 0.1, rel_p
    assert abs(err[2]) < 0.05
    assert float(qp.inlier_frac) > 0.5, float(qp.inlier_frac)


def test_keyframe_due_and_loop_candidates():
    assert bool(frontend.keyframe_due(jnp.zeros(3),
                                      jnp.asarray([0.6, 0.0, 0.0]), 0.5, 0.3))
    assert not bool(frontend.keyframe_due(jnp.zeros(3),
                                          jnp.asarray([0.1, 0.0, 0.1]), 0.5, 0.3))
    poses = jnp.asarray([[0, 0, 0], [5, 0, 0], [0.3, 0, 0], [0.1, 0, 0]],
                        jnp.float32)
    valid = jnp.ones(4, bool)
    mask = frontend.loop_candidates(poses, valid, 3, radius=1.0,
                                    min_index_gap=2)
    np.testing.assert_array_equal(np.asarray(mask), [True, False, False, False])


def test_active_gn_dx_equals_full_dense():
    """The bucketed active-prefix GN step (round-4 cost fix: both the dense
    LU and the H assembly pay for STATIC capacity, the measured dominant
    keyframe cost) must equal the full [3K, 3K] build + solve — exact by
    block-diagonality (edges never couple valid and invalid nodes; invalid
    rows are identity with zero b)."""
    # 24 nodes in a 128-capacity graph: bucket 32 is selected, 4x smaller
    g, _, _ = _circle_graph(n=24, max_nodes=128, max_edges=256)
    H, b = posegraph.build_normal_equations(g, anchor_weight=1e6,
                                            damping=1e-6)
    full = np.asarray(jnp.linalg.solve(H, -b))
    fast = np.asarray(posegraph._active_gn_dx(g, 1e6, 1e-6, 0.0))
    np.testing.assert_allclose(fast, full, atol=1e-5)
    # trailing (invalid-node) block: exactly zero both ways
    assert np.abs(fast[3 * 24:]).max() == 0.0
    np.testing.assert_allclose(full[3 * 24:], 0.0, atol=1e-7)

    # boundary: num_nodes exactly at capacity = the full build/solve path
    g2, _, _ = _circle_graph(n=32, max_nodes=32, max_edges=128)
    H2, b2 = posegraph.build_normal_equations(g2, 1e6, 1e-6)
    np.testing.assert_allclose(
        np.asarray(posegraph._active_gn_dx(g2, 1e6, 1e-6, 0.0)),
        np.asarray(jnp.linalg.solve(H2, -b2)), atol=1e-5)

    # under jit with a traced num_nodes (the production path inside lax.scan)
    fast_jit = np.asarray(jax.jit(
        lambda g: posegraph._active_gn_dx(g, 1e6, 1e-6, 0.0))(g))
    np.testing.assert_allclose(fast_jit, full, atol=1e-5)

    # with the robust kernel on (bucketed assembly must thread huber_delta)
    fast_h = np.asarray(posegraph._active_gn_dx(g, 1e6, 1e-6, 1.0))
    Hh, bh = posegraph.build_normal_equations(g, 1e6, 1e-6, 1.0)
    np.testing.assert_allclose(fast_h, np.asarray(jnp.linalg.solve(Hh, -bh)),
                               atol=1e-5)


def test_match_scans_pallas_mode():
    """matcher_mode="pallas" (ops/pallas_match, one 128-px level, 20
    iterations) must recover the relative pose and agree with the gather
    matcher to float summation order."""
    ref = _ring_scan((0.0, 0.0, 0.0))
    true_rel = np.asarray([0.4, -0.3, 0.08], np.float32)
    qry = _ring_scan(tuple(true_rel))

    gat = frontend.ScanMatchConfig(matcher_mode="gather", dense_fill=True)
    rel_g, qg = frontend.match_scans(ref, qry, (0.0, 0.0, 0.0), gat)
    pk = frontend.ScanMatchConfig(matcher_mode="pallas", dense_fill=True)
    rel_p, qp = frontend.match_scans(ref, qry, (0.0, 0.0, 0.0), pk)
    err = np.asarray(rel_p) - true_rel
    assert abs(err[0]) < 0.1 and abs(err[1]) < 0.1, rel_p
    assert abs(err[2]) < 0.05
    np.testing.assert_allclose(np.asarray(rel_p), np.asarray(rel_g),
                               atol=1e-4)
    assert float(qp.inlier_frac) > 0.5, float(qp.inlier_frac)
    np.testing.assert_allclose(float(qp.inlier_frac), float(qg.inlier_frac),
                               atol=0.01)
