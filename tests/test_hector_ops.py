"""Hector kernel tests: bilinear interp vs golden, GN solve, log-odds update vs
sequential reference semantics."""
import math

import jax.numpy as jnp
import numpy as np

from slamnet_tpu.ops import bilinear, gn, logodds

import golden


def _golden_interp(logodds_map, width, cx, cy):
    """InterpMapValueWithDerivatives golden (ScanMatcher.cs:211-249)."""
    if not (0.0 <= cx <= width - 2 and 0.0 <= cy <= width - 2):
        return 0.0, 0.0, 0.0
    x0, y0 = int(cx), int(cy)
    fx, fy = cx - x0, cy - y0
    idx = y0 * width + x0
    sig = lambda v: math.exp(v) / (math.exp(v) + 1.0)
    i0 = sig(logodds_map[idx])
    i1 = sig(logodds_map[idx + 1])
    i2 = sig(logodds_map[idx + width])
    i3 = sig(logodds_map[idx + width + 1])
    dx1, dx2 = i0 - i1, i2 - i3
    dy1, dy2 = i0 - i2, i1 - i3
    xf, yf = 1 - fx, 1 - fy
    val = (i0 * xf + i1 * fx) * yf + (i2 * xf + i3 * fx) * fy
    return val, -(dx1 * xf + dx2 * fx), -(dy1 * yf + dy2 * fy)


def test_bilinear_matches_golden():
    width = 32
    rng = np.random.default_rng(0)
    lo = rng.normal(0, 2, width * width).astype(np.float32)
    coords = rng.uniform(-2, width + 1, (200, 2)).astype(np.float32)
    v, gx, gy = bilinear.interp_value_and_gradients(
        jnp.asarray(lo), width, jnp.asarray(coords), jnp.ones(200, bool))
    for i in range(200):
        wv, wgx, wgy = _golden_interp(lo, width, float(coords[i, 0]),
                                      float(coords[i, 1]))
        np.testing.assert_allclose(float(v[i]), wv, atol=2e-5)
        np.testing.assert_allclose(float(gx[i]), wgx, atol=2e-5)
        np.testing.assert_allclose(float(gy[i]), wgy, atol=2e-5)


def test_gn_solve_exact_and_guards():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(3, 3))
    H = (A @ A.T + np.eye(3)).astype(np.float32)   # SPD
    x = rng.normal(size=3).astype(np.float32)
    d = H @ x
    step = gn.solve_gn_step(jnp.asarray(H), jnp.asarray(d), deriv_clamp=10.0)
    np.testing.assert_allclose(np.asarray(step), x, rtol=1e-4, atol=1e-4)
    # rotation clamp
    step = gn.solve_gn_step(jnp.asarray(np.eye(3, dtype=np.float32)),
                            jnp.asarray([0.0, 0.0, 5.0], jnp.float32))
    assert abs(float(step[2]) - 0.2) < 1e-6
    # guard: H00 == 0 -> zero step (ScanMatcher.cs:97)
    H0 = np.eye(3, dtype=np.float32); H0[0, 0] = 0.0
    step = gn.solve_gn_step(jnp.asarray(H0), jnp.asarray([1.0, 1.0, 1.0]))
    np.testing.assert_array_equal(np.asarray(step), 0.0)
    # guard: singular H -> zero step
    H1 = np.ones((3, 3), np.float32)
    step = gn.solve_gn_step(jnp.asarray(H1), jnp.asarray([1.0, 1.0, 1.0]))
    np.testing.assert_array_equal(np.asarray(step), 0.0)


def _golden_occupancy_update(lo, width, pts, valid, pose, scan_pose, scale,
                             lof, loo, cap=50.0):
    """Sequential UpdateByScan golden with generation-counter semantics
    (OccGridMap.cs:114-239)."""
    update_index = np.full(width * width, -1, np.int64)
    FREE, OCC = 1, 2
    c, s = math.cos(pose[2]), math.sin(pose[2])

    def rnd(v):  # .NET banker's rounding
        return int(np.round(v))

    bx = rnd((c * scan_pose[0] - s * scan_pose[1] + pose[0]) * scale)
    by = rnd((s * scan_pose[0] + c * scan_pose[1] + pose[1]) * scale)
    for i, (X, Y) in enumerate(pts):
        if not valid[i]:
            continue
        ex = rnd((c * X - s * Y + pose[0]) * scale)
        ey = rnd((s * X + c * Y + pose[1]) * scale)
        if (ex, ey) == (bx, by):
            continue
        if not (0 <= bx < width and 0 <= by < width and 0 <= ex < width
                and 0 <= ey < width):
            continue
        for off in golden.hector_bresenham_free_cells((bx, by), (ex, ey), width):
            if update_index[off] < FREE:
                lo[off] += lof
                update_index[off] = FREE
        endo = ey * width + ex
        if update_index[endo] < OCC:
            if update_index[endo] == FREE:
                lo[endo] -= lof
            if lo[endo] < cap:
                lo[endo] += loo
            update_index[endo] = OCC
    return lo


def test_occupancy_update_matches_sequential():
    width, scale = 64, 1.6
    rng = np.random.default_rng(2)
    pose = np.array([20.0, 20.0, 0.35], np.float32)
    n = 150
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = rng.uniform(1.0, 25.0, n)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    valid = rng.random(n) > 0.1
    lof, loo = math.log(0.4 / 0.6), math.log(0.9 / 0.1)

    lo0 = rng.normal(0, 1, width * width).astype(np.float32)
    want = _golden_occupancy_update(lo0.astype(np.float64).copy(), width, pts,
                                    valid, pose, (0.0, 0.0), scale, lof, loo)
    got = np.asarray(logodds.update_occupancy(
        jnp.asarray(lo0), width, jnp.asarray(pts), jnp.asarray(valid),
        jnp.asarray(pose), jnp.zeros(2, jnp.float32), scale, lof, loo))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_occupancy_cap_blocks_further_occupied():
    width = 16
    lo = np.zeros(width * width, np.float32)
    pose = jnp.asarray([4.0, 4.0, 0.0], jnp.float32)
    pts = jnp.asarray([[4.0, 0.0]], jnp.float32)  # endpoint at (8,4)
    lo[4 * width + 8] = 55.0  # over the 50 cap
    out = np.asarray(logodds.update_occupancy(
        jnp.asarray(lo), width, pts, jnp.ones(1, bool), pose,
        jnp.zeros(2, jnp.float32), 1.0, -0.4, 2.2))
    assert out[4 * width + 8] == 55.0  # capped: no further increment
    assert out[4 * width + 5] < 0.0    # free cells still marked


def test_onehot_matcher_identical_to_gather():
    # the one-hot gather variant must pick IDENTICAL neighbor values, so
    # the whole match is bit-identical to the take()-based matcher
    import dataclasses
    import jax
    from slamnet_tpu.core import HectorConfig, SimConfig
    from slamnet_tpu.core.scan import Scan
    from slamnet_tpu.models import hector
    from slamnet_tpu.sim import default_field, lidar

    cfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4))
    sim = SimConfig()
    fld = default_field()
    angles = jnp.asarray(lidar.revolution_angles(sim.num_scan_points))
    truth = jnp.asarray([20.0, 20.0, 0.0], jnp.float32)
    state = hector.init(cfg, truth)
    key = jax.random.PRNGKey(0)
    for t in range(6):
        key, sub = jax.random.split(key)
        radii, valid = lidar.scan_revolution(fld, truth, angles,
                                             sim.max_scan_dist,
                                             sim.measure_error, sub)
        pts = jnp.stack([radii * jnp.cos(angles), radii * jnp.sin(angles)], -1)
        state, _ = hector.update(state, Scan(pts, valid, jnp.zeros(3)),
                                 truth, cfg, map_without_matching=True)

    key, sub = jax.random.split(key)
    radii, valid = lidar.scan_revolution(fld, truth, angles,
                                         sim.max_scan_dist,
                                         sim.measure_error, sub)
    pts = jnp.stack([radii * jnp.cos(angles), radii * jnp.sin(angles)], -1)
    scan = Scan(pts, valid, jnp.zeros(3))
    hint = truth + jnp.asarray([0.2, -0.15, 0.04])

    pose_g, stats_g = hector.match_with_stats(state.maps, scan, hint, cfg)
    oh = dataclasses.replace(cfg, matcher_mode="onehot_highest")
    pose_o, stats_o = hector.match_with_stats(state.maps, scan, hint, oh)
    np.testing.assert_array_equal(np.asarray(pose_o), np.asarray(pose_g))
    assert int(stats_o.solve_failures) == int(stats_g.solve_failures)
    np.testing.assert_array_equal(np.asarray(stats_o.residual),
                                  np.asarray(stats_g.residual))
