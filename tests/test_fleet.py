"""Fleet serving: batched instances track independently and match the unbatched
pipeline."""
import jax
import jax.numpy as jnp
import numpy as np

from slamnet_tpu.core import HectorConfig, SimConfig
from slamnet_tpu.core.scan import Scan
from slamnet_tpu.models import fleet, hector
from slamnet_tpu.sim import default_field, lidar
from slamnet_tpu.sim.trajectory import stationary_trajectory


def test_fleet_tracks_multiple_poses():
    cfg = HectorConfig(num_levels=2, map_size=128, estimate_iterations=(5, 4),
                       map_resolution=0.3125)  # 40 m span at 128 px
    sim = SimConfig()
    fld = default_field()
    angles = jnp.asarray(lidar.revolution_angles(200))
    starts = np.asarray([[20.0, 20.0, 0.0], [26.0, 12.0, 1.0],
                         [12.0, 28.0, -0.7], [24.0, 28.0, 2.0]], np.float32)
    b = starts.shape[0]
    states = fleet.init_fleet(cfg, starts)

    @jax.jit
    def step(states, key, boot):
        keys = jax.random.split(key, b)
        def scan_one(p, k):
            return lidar.scan_revolution(fld, p, angles, sim.max_scan_dist,
                                         sim.measure_error, k)
        radii, valid = jax.vmap(scan_one)(jnp.asarray(starts), keys)
        pts = jnp.stack([radii * jnp.cos(angles)[None], radii * jnp.sin(angles)[None]], -1)
        return fleet.update_fleet(states, pts, valid, cfg,
                                  map_without_matching=boot)

    key = jax.random.PRNGKey(0)
    for t in range(15):
        key, sub = jax.random.split(key)
        states, info = step(states, sub, jnp.asarray(t < 5))

    err = np.asarray(states.match_pose) - starts
    assert np.linalg.norm(err[:, :2], axis=1).max() < 0.3
    # instances built DIFFERENT maps (different viewpoints)
    m = np.asarray(states.maps).reshape(b, -1)
    occupied = (m > 0).sum(axis=1)
    assert (occupied > 50).all()
    assert np.abs(np.diff(occupied)).max() > 0   # not identical


def test_fleet_matches_unbatched_single_instance():
    cfg = HectorConfig(num_levels=2, map_size=64, estimate_iterations=(3, 3),
                       map_resolution=0.625)
    n = 100
    rng = np.random.default_rng(0)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False).astype(np.float32)
    r = rng.uniform(3.0, 15.0, n).astype(np.float32)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)

    single = hector.init(cfg, (20.0, 20.0, 0.0))
    batch = fleet.init_fleet(cfg, np.asarray([[20.0, 20.0, 0.0]], np.float32))

    for boot in (True, True, False, False):
        cloud = Scan(jnp.asarray(pts), jnp.ones(n, bool),
                     jnp.zeros(3, jnp.float32))
        single, _ = hector.update(single, cloud, single.match_pose, cfg,
                                  map_without_matching=jnp.asarray(boot))
        batch, _ = fleet.update_fleet(batch, jnp.asarray(pts)[None],
                                      jnp.ones((1, n), bool), cfg,
                                      map_without_matching=boot)
    np.testing.assert_allclose(np.asarray(batch.match_pose[0]),
                               np.asarray(single.match_pose), atol=1e-5)
    np.testing.assert_allclose(np.asarray(batch.maps),
                               np.asarray(single.maps), atol=1e-5)


def test_fleet_update_budget_defers_not_drops():
    """With fleet_update_capacity=1 every instance's gate is armed at init
    (last_update_pose = -FLT_MAX => infinite displacement): each batch-scan
    must update exactly ONE instance, and deferred instances keep their gate
    armed (last_update_pose unchanged) until their turn — nobody is dropped."""
    cfg = HectorConfig(num_levels=1, map_size=64, estimate_iterations=(1,),
                       map_resolution=0.625, fleet_update_capacity=1)
    b, n = 3, 64
    rng = np.random.default_rng(1)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False).astype(np.float32)
    r = rng.uniform(3.0, 15.0, n).astype(np.float32)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    pts_b = jnp.broadcast_to(jnp.asarray(pts), (b, n, 2))
    val_b = jnp.ones((b, n), bool)

    states = fleet.init_fleet(
        cfg, np.tile(np.asarray([20.0, 20.0, 0.0], np.float32), (b, 1)))
    seen = np.zeros(b, int)
    for t in range(b):
        states, info = fleet.update_fleet(states, pts_b, val_b, cfg)
        upd = np.asarray(info.map_updated)
        assert upd.sum() == 1, upd            # budget respected
        seen += upd.astype(int)
    # after b scans every instance got its (deferred) first update exactly
    # once: an updated instance's gate disarms (its last_update_pose moved to
    # the matched pose), so the argsort priority passes to the deferred ones.
    np.testing.assert_array_equal(seen, np.ones(b, int))


def test_gn_damping_default_is_parity_and_positive_damps():
    """damping=0 leaves the solve bit-identical; damping>0 shrinks the step."""
    from slamnet_tpu.ops import gn
    rng = np.random.default_rng(3)
    A = rng.normal(0, 1, (3, 8))
    H = A @ A.T + np.eye(3) * 0.1
    d = rng.normal(0, 1, 3)
    args = (jnp.float32(H[0, 0]), jnp.float32(H[0, 1]), jnp.float32(H[0, 2]),
            jnp.float32(H[1, 1]), jnp.float32(H[1, 2]), jnp.float32(H[2, 2]),
            jnp.float32(d[0]), jnp.float32(d[1]), jnp.float32(d[2]), 0.2)
    s_plain = np.asarray(gn._solve_scalar(*args)[:3])
    s_zero = np.asarray(gn._solve_scalar(*args, damping=0.0)[:3])
    s_damped = np.asarray(gn._solve_scalar(*args, damping=0.5)[:3])
    np.testing.assert_array_equal(s_plain, s_zero)
    assert np.linalg.norm(s_damped) < np.linalg.norm(s_plain)


def test_fleet_over_mesh_equals_local_fleets():
    # multi-device serving: B instances sharded over 8 devices must
    # equal 8 INDEPENDENT local fleets of B/8 run unsharded (instances don't
    # interact; the phase-3 update budget applies per shard by design)
    import pytest
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from slamnet_tpu.parallel import make_mesh

    cfg = HectorConfig(num_levels=2, map_size=128, estimate_iterations=(5, 4),
                       map_resolution=0.3125)
    sim = SimConfig()
    fld = default_field()
    angles = jnp.asarray(lidar.revolution_angles(200))
    b, s = 16, 8
    rng = np.random.default_rng(3)
    starts = np.stack([rng.uniform(14, 26, b), rng.uniform(14, 26, b),
                       rng.uniform(-1, 1, b)], -1).astype(np.float32)

    @jax.jit
    def gen(key):
        keys = jax.random.split(key, b)

        def one(p, k):
            return lidar.scan_revolution(fld, p, angles, sim.max_scan_dist,
                                         sim.measure_error, k)
        return jax.vmap(one)(jnp.asarray(starts), keys)

    logs = [gen(jax.random.PRNGKey(t)) for t in range(8)]

    mesh = make_mesh({"search": s})
    sharded_states = fleet.init_fleet(cfg, starts)
    sh_step = fleet.make_fleet_step(mesh, cfg)
    for t in range(8):
        radii, valid = logs[t]
        pts = jnp.stack([radii * jnp.cos(angles)[None],
                         radii * jnp.sin(angles)[None]], -1)
        sharded_states, _ = sh_step(sharded_states, pts, valid,
                                    jnp.asarray(t < 3))

    per = b // s
    cells = fleet.fleet_cells(cfg)
    dense_maps, dense_poses = [], []
    for shard in range(s):
        sl = slice(shard * per, (shard + 1) * per)
        st = fleet.init_fleet(cfg, starts[sl])
        for t in range(8):
            radii, valid = logs[t]
            pts = jnp.stack([radii * jnp.cos(angles)[None],
                             radii * jnp.sin(angles)[None]], -1)
            st, _ = fleet.update_fleet(st, pts[sl], valid[sl], cfg,
                                       map_without_matching=jnp.asarray(t < 3))
        dense_maps.append(np.asarray(st.maps).reshape(per, cells))
        dense_poses.append(np.asarray(st.match_pose))

    np.testing.assert_array_equal(
        np.asarray(sharded_states.maps).reshape(b, cells),
        np.concatenate(dense_maps))
    # poses to ULP tolerance: XLA reassociates the matcher's [9, N] reduction
    # differently for the sharded vs unsharded program shapes
    np.testing.assert_allclose(np.asarray(sharded_states.match_pose),
                               np.concatenate(dense_poses), rtol=0, atol=2e-5)


def test_fleet_onehot_matcher_identical_to_gather():
    # batched one-hot gather == batched take() gather, bit-for-bit (on
    # CPU matmuls are exact f32; on the GPU the "highest" precision mode is
    # the exact one — bench.py ATE-gates the bf16 fast path)
    import dataclasses
    cfg = HectorConfig(num_levels=2, map_size=128, estimate_iterations=(5, 4),
                       map_resolution=0.3125)
    sim = SimConfig()
    fld = default_field()
    angles = jnp.asarray(lidar.revolution_angles(200))
    starts = np.asarray([[20.0, 20.0, 0.0], [26.0, 12.0, 1.0],
                         [12.0, 28.0, -0.7], [24.0, 28.0, 2.0]], np.float32)
    b = starts.shape[0]
    states = fleet.init_fleet(cfg, starts)

    key = jax.random.PRNGKey(4)

    def scans(key):
        keys = jax.random.split(key, b)

        def one(p, k):
            return lidar.scan_revolution(fld, p, angles, sim.max_scan_dist,
                                         sim.measure_error, k)
        radii, valid = jax.vmap(one)(jnp.asarray(starts), keys)
        pts = jnp.stack([radii * jnp.cos(angles)[None],
                         radii * jnp.sin(angles)[None]], -1)
        return pts, valid

    for t in range(6):
        key, sub = jax.random.split(key)
        pts, valid = scans(sub)
        states, _ = fleet.update_fleet(states, pts, valid, cfg,
                                       map_without_matching=True)

    key, sub = jax.random.split(key)
    pts, valid = scans(sub)
    plain, _ = fleet.update_fleet(states, pts, valid, cfg)
    oh_cfg = dataclasses.replace(cfg, matcher_mode="onehot_highest")
    oh, _ = fleet.update_fleet(states, pts, valid, oh_cfg)
    np.testing.assert_array_equal(np.asarray(oh.match_pose),
                                  np.asarray(plain.match_pose))
    np.testing.assert_array_equal(np.asarray(oh.maps), np.asarray(plain.maps))


def test_fleet_pallas_matcher_matches_per_instance_pallas():
    # the fleet runs the matcher kernel with one program per instance, so
    # each instance's match must be bit-for-bit the per-instance hector
    # pallas match (interpret mode on CPU), and agree with the batched
    # gather matcher to float summation order
    import dataclasses
    cfg = HectorConfig(num_levels=2, map_size=128, estimate_iterations=(5, 4),
                       map_resolution=0.3125)
    sim = SimConfig()
    fld = default_field()
    angles = jnp.asarray(lidar.revolution_angles(200))
    starts = np.asarray([[20.0, 20.0, 0.0], [26.0, 12.0, 1.0],
                         [12.0, 28.0, -0.7], [24.0, 28.0, 2.0]], np.float32)
    b = starts.shape[0]
    states = fleet.init_fleet(cfg, starts)
    key = jax.random.PRNGKey(11)

    def scans(key):
        keys = jax.random.split(key, b)

        def one(p, k):
            return lidar.scan_revolution(fld, p, angles, sim.max_scan_dist,
                                         sim.measure_error, k)
        radii, valid = jax.vmap(one)(jnp.asarray(starts), keys)
        pts = jnp.stack([radii * jnp.cos(angles)[None],
                         radii * jnp.sin(angles)[None]], -1)
        return pts, valid

    for t in range(6):
        key, sub = jax.random.split(key)
        pts, valid = scans(sub)
        states, _ = fleet.update_fleet(states, pts, valid, cfg,
                                       map_without_matching=True)

    key, sub = jax.random.split(key)
    pts, valid = scans(sub)
    gcfg = dataclasses.replace(cfg, match_subsample=2)
    pcfg = dataclasses.replace(gcfg, matcher_mode="pallas")
    hints = states.match_pose + jnp.asarray([[0.1, -0.05, 0.02]] * b,
                                            jnp.float32)
    poses_b, stats_b = fleet._match_batch(states.maps, fleet.fleet_cells(cfg),
                                          pts, valid, hints, pcfg)
    maps2d = states.maps.reshape(b, -1)
    for i in range(b):
        scan_i = Scan(pts[i], valid[i], jnp.zeros(3, jnp.float32))
        pose_i, st_i = hector.match_with_stats(maps2d[i], scan_i, hints[i],
                                               pcfg)
        np.testing.assert_array_equal(np.asarray(poses_b[i]),
                                      np.asarray(pose_i))
        assert int(stats_b.solve_failures[i]) == int(st_i.solve_failures)

    poses_g, stats_g = fleet._match_batch(states.maps, fleet.fleet_cells(cfg),
                                          pts, valid, hints, gcfg)
    np.testing.assert_allclose(np.asarray(poses_b), np.asarray(poses_g),
                               atol=1e-4)
    np.testing.assert_array_equal(np.asarray(stats_b.solve_failures),
                                  np.asarray(stats_g.solve_failures))

    # and the full fleet step runs end-to-end with the pallas matcher
    st2, info = fleet.update_fleet(states, pts, valid, pcfg)
    assert np.isfinite(np.asarray(st2.match_pose)).all()


def test_serving_profile_encodes_measured_defaults():
    # the fleet-serving profile is the measured ablation's conclusion
    # (PERF.md; VERDICT r04 item 6): damping on, guards on, sub4 +
    # one-hot matcher, uncapped updates
    from slamnet_tpu.core import serving_hector_config
    cfg = serving_hector_config()
    assert cfg.gn_damping == 0.1
    assert cfg.xy_step_clamp_px == 10.0
    assert cfg.max_match_jump == 1.0
    assert cfg.match_subsample == 4
    assert cfg.matcher_mode == "onehot_bf16"
    assert cfg.fleet_update_capacity >= 1 << 20      # uncapped
    # overrides compose
    c2 = serving_hector_config(num_levels=2, map_size=128)
    assert c2.num_levels == 2 and c2.gn_damping == 0.1
    # and a fleet actually runs with it (tiny smoke)
    import dataclasses
    small = serving_hector_config(num_levels=2, map_size=64,
                                  map_resolution=0.625, match_subsample=1,
                                  estimate_iterations=(3, 3))
    states = fleet.init_fleet(small, np.asarray([[20.0, 20.0, 0.0],
                                                 [22.0, 18.0, 0.5]],
                                                np.float32))
    n = 100
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False).astype(np.float32)
    r = np.full(n, 8.0, np.float32)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
    pts = np.broadcast_to(pts, (2, n, 2))
    sts, _ = fleet.update_fleet(states, jnp.asarray(pts),
                                jnp.ones((2, n), bool), small,
                                map_without_matching=True)
    assert np.isfinite(np.asarray(sts.match_pose)).all()
