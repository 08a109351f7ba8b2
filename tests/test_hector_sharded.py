"""Sharded full-pipeline Hector == dense pipeline (VERDICT round-1 task 1).

On the 8-virtual-device CPU mesh ('tile' x 'search'): the row-tiled 3-level
400x400 pyramid with halo exchange + beam-sharded (H,dTr) psum must reproduce
the dense models/hector.py pipeline — map updates bitwise (the free/occ masks
are sharding-invariant unions), matcher poses to float-summation tolerance —
over a bench-trajectory replay.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slamnet_tpu.core import HectorConfig, SimConfig
from slamnet_tpu.core.scan import Scan
from slamnet_tpu.models import hector, hector_sharded
from slamnet_tpu.parallel import make_mesh
from slamnet_tpu.sim import default_field, lidar
from slamnet_tpu.sim.trajectory import loop_trajectory

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 devices")

CFG = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4))


def _mesh():
    return make_mesh({"tile": 4, "search": 2})


def _scan_log(n_scans, speed=0.3):
    sim = SimConfig()
    fld = default_field()
    angles = jnp.asarray(lidar.revolution_angles(sim.num_scan_points))
    traj = loop_trajectory(speed=speed)[:n_scans]

    @jax.jit
    def gen(poses, key):
        keys = jax.random.split(key, poses.shape[0])

        def one(p, k):
            return lidar.scan_revolution(fld, p, angles, sim.max_scan_dist,
                                         sim.measure_error, k)
        return jax.vmap(one)(poses, keys)

    radii, valids = gen(jnp.asarray(traj), jax.random.PRNGKey(0))
    pts = jnp.stack([radii * jnp.cos(angles)[None], radii * jnp.sin(angles)[None]],
                    -1)
    return np.asarray(traj), pts, valids


def test_shard_roundtrip_identity():
    rng = np.random.default_rng(0)
    dense = hector.init(CFG, (20.0, 20.0, 0.0))
    dense = dense._replace(
        maps=jnp.asarray(rng.normal(0, 1, CFG.total_cells), jnp.float32))
    st = hector_sharded.shard_state(_mesh(), dense, CFG)
    back = hector_sharded.unshard_maps(st, CFG)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(dense.maps))


def test_forced_update_bitwise_equal():
    # force=True: the pose is the hint on both paths, so the gated update must
    # produce BITWISE identical maps (masks are sharding-invariant unions)
    traj, pts, valids = _scan_log(3)
    dense = hector.init(CFG, traj[0])
    mesh = _mesh()
    sh = hector_sharded.shard_state(mesh, dense, CFG)
    step = hector_sharded.make_step(mesh, CFG, pts.shape[1])

    for t in range(3):
        cloud = Scan(pts[t], valids[t], jnp.zeros(3, jnp.float32))
        dense, _ = hector.update(dense, cloud, jnp.asarray(traj[t]), CFG,
                                 map_without_matching=jnp.asarray(True))
        dense = dense._replace(match_pose=jnp.asarray(traj[t], jnp.float32))
        sh = sh._replace(match_pose=jnp.asarray(traj[t], jnp.float32))
        sh, _ = step(sh, pts[t], valids[t], jnp.asarray(True))

    np.testing.assert_array_equal(
        np.asarray(hector_sharded.unshard_maps(sh, CFG)),
        np.asarray(dense.maps))


def test_match_equals_dense_to_float_tolerance():
    # warm a map, then compare a pure match (no update motion) step
    traj, pts, valids = _scan_log(12)
    dense = hector.init(CFG, traj[0])
    for t in range(10):
        cloud = Scan(pts[t], valids[t], jnp.zeros(3, jnp.float32))
        dense, _ = hector.update(dense, cloud, jnp.asarray(traj[t]), CFG,
                                 map_without_matching=jnp.asarray(True))
    mesh = _mesh()
    sh = hector_sharded.shard_state(mesh, dense, CFG)
    step = hector_sharded.make_step(mesh, CFG, pts.shape[1])

    cloud = Scan(pts[10], valids[10], jnp.zeros(3, jnp.float32))
    dense2, dinfo = hector.update(dense, cloud, dense.match_pose, CFG,
                                  map_without_matching=jnp.asarray(False))
    sh2, sinfo = step(sh, pts[10], valids[10], jnp.asarray(False))

    np.testing.assert_allclose(np.asarray(sh2.match_pose),
                               np.asarray(dense2.match_pose),
                               rtol=0, atol=2e-4)
    assert bool(sinfo.map_updated) == bool(dinfo.map_updated)
    assert int(sinfo.gn_iterations) == int(dinfo.gn_iterations)
    assert int(sinfo.solve_failures) == int(dinfo.solve_failures)
    np.testing.assert_allclose(float(sinfo.residual), float(dinfo.residual),
                               rtol=1e-3, atol=1e-5)


def test_tile8_padded_rows_equal_dense():
    # tile=8 on the flagship pyramid (400/200/100): 100 rows don't divide by 8,
    # so the last tiles own padding rows (hector_sharded.level_rows) — the
    # VERDICT round-2 divisibility limit, now lifted.  Forced updates must stay
    # BITWISE equal and a matched step must agree to float tolerance.
    traj, pts, valids = _scan_log(12)
    mesh = make_mesh({"tile": 8, "search": 1})
    dense = hector.init(CFG, traj[0])
    sh = hector_sharded.shard_state(mesh, dense, CFG)
    step = hector_sharded.make_step(mesh, CFG, pts.shape[1])

    for t in range(10):
        cloud = Scan(pts[t], valids[t], jnp.zeros(3, jnp.float32))
        dense, _ = hector.update(dense, cloud, jnp.asarray(traj[t]), CFG,
                                 map_without_matching=jnp.asarray(True))
        dense = dense._replace(match_pose=jnp.asarray(traj[t], jnp.float32))
        sh = sh._replace(match_pose=jnp.asarray(traj[t], jnp.float32))
        sh, _ = step(sh, pts[t], valids[t], jnp.asarray(True))

    np.testing.assert_array_equal(
        np.asarray(hector_sharded.unshard_maps(sh, CFG)),
        np.asarray(dense.maps))

    dense2, dinfo = hector.update(
        dense, Scan(pts[10], valids[10], jnp.zeros(3, jnp.float32)),
        dense.match_pose, CFG, map_without_matching=jnp.asarray(False))
    sh2, sinfo = step(sh, pts[10], valids[10], jnp.asarray(False))
    np.testing.assert_allclose(np.asarray(sh2.match_pose),
                               np.asarray(dense2.match_pose),
                               rtol=0, atol=2e-4)
    assert int(sinfo.gn_iterations) == int(dinfo.gn_iterations)


def test_onehot_matcher_modes():
    # the sharded one-hot matcher (matcher_mode="onehot_highest"): the
    # one-hot row matmuls against the [rows+1, width] tile view must select
    # entries EXACTLY, so the whole sharded replay is BIT-identical to the
    # sharded gather matcher; onehot_bf16 (bf16-rounded table) must stay within
    # match tolerance of it.
    import dataclasses
    n = 24
    bootstrap = 10
    traj, pts, valids = _scan_log(n)
    mesh = _mesh()

    def replay(cfg):
        sh = hector_sharded.shard_state(
            mesh, hector.init(cfg, traj[0]), cfg)
        step = hector_sharded.make_step(mesh, cfg, pts.shape[1])
        poses = []
        for t in range(n):
            force = jnp.asarray(t < bootstrap)
            if t < bootstrap:
                sh = sh._replace(match_pose=jnp.asarray(traj[t], jnp.float32))
            sh, _ = step(sh, pts[t], valids[t], force)
            poses.append(np.asarray(sh.match_pose))
        return np.asarray(poses), np.asarray(
            hector_sharded.unshard_maps(sh, cfg))

    g_poses, g_maps = replay(CFG)
    oh_poses, oh_maps = replay(
        dataclasses.replace(CFG, matcher_mode="onehot_highest"))
    np.testing.assert_array_equal(oh_poses, g_poses)
    np.testing.assert_array_equal(oh_maps, g_maps)

    bf_poses, _ = replay(dataclasses.replace(CFG, matcher_mode="onehot_bf16"))
    np.testing.assert_allclose(bf_poses, g_poses, rtol=0, atol=5e-3)


def test_bench_trajectory_replay_tracks_dense():
    # the VERDICT "done" criterion: a CPU-mesh replay of the bench trajectory
    # whose pose track equals the dense pipeline to float tolerance
    n = 160
    bootstrap = 10
    traj, pts, valids = _scan_log(n)
    mesh = _mesh()
    step = hector_sharded.make_step(mesh, CFG, pts.shape[1])

    dense = hector.init(CFG, traj[0])
    sh = hector_sharded.shard_state(mesh, dense, CFG)

    @jax.jit
    def dense_step(st, p, v, hint, force):
        cloud = Scan(p, v, jnp.zeros(3, jnp.float32))
        return hector.update(st, cloud, hint, CFG, map_without_matching=force)

    d_poses, s_poses, d_upd, s_upd = [], [], 0, 0
    for t in range(n):
        force = jnp.asarray(t < bootstrap)
        hint_d = jnp.asarray(traj[t]) if t < bootstrap else dense.match_pose
        dense, di = dense_step(dense, pts[t], valids[t], hint_d, force)
        if t < bootstrap:
            dense = dense._replace(match_pose=jnp.asarray(traj[t], jnp.float32))
            sh = sh._replace(match_pose=jnp.asarray(traj[t], jnp.float32))
        sh, si = step(sh, pts[t], valids[t], force)
        d_poses.append(np.asarray(dense.match_pose))
        s_poses.append(np.asarray(sh.match_pose))
        d_upd += int(di.map_updated)
        s_upd += int(si.map_updated)

    d_poses = np.asarray(d_poses)
    s_poses = np.asarray(s_poses)
    assert d_upd == s_upd
    # float-summation-order tolerance, accumulated over the replay
    np.testing.assert_allclose(s_poses, d_poses, rtol=0, atol=5e-3)
    # and the final maps agree wherever both were written
    diff = np.abs(np.asarray(hector_sharded.unshard_maps(sh, CFG))
                  - np.asarray(dense.maps))
    assert diff.max() < 1e-2, diff.max()


def test_pallas_matcher_is_single_device():
    # the matcher kernel runs a whole match per program; the sharded matcher
    # psums (H, dTr) every iteration, so it refuses the mode instead of
    # silently running another matcher
    import dataclasses
    with pytest.raises(ValueError, match="single-device"):
        hector_sharded.make_step(
            _mesh(), dataclasses.replace(CFG, matcher_mode="pallas"), 400)
