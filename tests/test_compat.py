"""Compat layer (reference-shaped OO API), geometry additions, map extents,
determinism (the race-detection stand-in of SURVEY.md §5.2)."""
import math

import jax
import jax.numpy as jnp
import numpy as np

from slamnet_tpu import compat
from slamnet_tpu.core import HectorConfig, SimConfig
from slamnet_tpu.core import geometry as g
from slamnet_tpu.core.scan import Scan
from slamnet_tpu.models import coreslam, hector
from slamnet_tpu.sim import default_field, lidar, make_segment_scan


def _scan_pair(key, pose=(20.0, 20.0, 0.0)):
    sim = SimConfig()
    fld = default_field()
    angles = jnp.asarray(lidar.revolution_angles(sim.num_scan_points))
    radii, valid = lidar.scan_revolution(fld, pose, angles, sim.max_scan_dist,
                                         sim.measure_error, key)
    pts = jnp.stack([radii * jnp.cos(angles), radii * jnp.sin(angles)], -1)
    cloud = Scan(pts, valid, jnp.zeros(3, jnp.float32))
    seg = make_segment_scan(angles, radii, valid,
                            np.asarray(pose, np.float32))
    return cloud, seg


def test_compat_coreslam_reference_surface():
    proc = compat.CoreSLAMProcessor(40.0, 128, 64, (20.0, 20.0, 0.0),
                                    0.1, math.radians(10), 256, 4,
                                    hole_width=2.0)
    key = jax.random.PRNGKey(0)
    for i in range(3):
        key, sub = jax.random.split(key)
        _, seg = _scan_pair(sub)
        proc.Update(seg)
    assert np.linalg.norm(proc.Pose[:2] - [20.0, 20.0]) < 0.2
    assert proc.HoleMap.shape == (128, 128)
    assert proc.ObstacleMap.shape == (64, 64)
    proc.Reset()
    assert (proc.HoleMap == coreslam.HOLE_INIT).all()


def test_compat_hector_reference_surface():
    proc = compat.HectorSLAMProcessor(0.1, 400, (20.0, 20.0, 0.0), 4, 4,
                                      estimate_iterations=(7, 4, 4, 4))
    key = jax.random.PRNGKey(1)
    for i in range(4):
        key, sub = jax.random.split(key)
        cloud, _ = _scan_pair(sub)
        updated = proc.Update(cloud, map_without_matching=(i < 2))
    assert np.linalg.norm(proc.MatchPose[:2] - [20.0, 20.0]) < 0.2
    assert len(proc.MapRep) == 4
    assert proc.MapRep[0].shape == (400, 400)
    bmp = proc.GetBitmapData(0)
    assert set(np.unique(bmp)) <= {0, 127, 254}
    assert proc.MatchTiming.ms > 0.0


def test_compat_hector_matcher_mode():
    # the one-hot matcher is reachable from the OO surface;
    # onehot_highest tracks exactly like the default gather matcher
    def drive(mode):
        proc = compat.HectorSLAMProcessor(0.1, 400, (20.0, 20.0, 0.0), 3, 4,
                                          estimate_iterations=(7, 4, 4),
                                          matcher_mode=mode)
        key = jax.random.PRNGKey(2)
        for i in range(4):
            key, sub = jax.random.split(key)
            cloud, _ = _scan_pair(sub)
            proc.Update(cloud, map_without_matching=(i < 2))
        return proc.MatchPose

    np.testing.assert_array_equal(drive("onehot_highest"), drive("gather"))


def test_geometry_line_helpers():
    p = g.find_position_on_line(jnp.asarray([1.0, 1.0]),
                                jnp.asarray([0.0, 0.0]),
                                jnp.asarray([2.0, 0.0]))
    np.testing.assert_allclose(np.asarray(p), [1.0, 0.0], atol=1e-6)
    d = g.point_to_line_distance(jnp.asarray([1.0, 3.0]),
                                 jnp.asarray([0.0, 0.0]),
                                 jnp.asarray([2.0, 0.0]))
    assert abs(float(d) - 3.0) < 1e-6
    assert float(g.limit(5.0, 0.0, 2.0)) == 2.0


def test_map_extents():
    cfg = HectorConfig(num_levels=1, map_size=32, estimate_iterations=(1,))
    st = hector.init(cfg, (0.0, 0.0, 0.0))
    found, *_ = hector.map_extents(st.maps, cfg)
    assert not bool(found)
    maps = st.maps.at[5 * 32 + 7].set(1.0).at[20 * 32 + 12].set(-1.0)
    found, x0, y0, x1, y1 = hector.map_extents(maps, cfg)
    assert bool(found)
    assert (int(x0), int(y0), int(x1), int(y1)) == (7, 5, 12, 20)


def test_bitwise_determinism_same_key():
    # SURVEY.md §5.2: JAX purity removes data races; what remains is
    # reproducibility — two runs with the same key must be BITWISE identical.
    def run():
        cloud, seg = _scan_pair(jax.random.PRNGKey(42))
        cfg = HectorConfig(num_levels=2, map_size=128,
                           estimate_iterations=(3, 3), map_resolution=0.3125)
        st = hector.init(cfg, (20.0, 20.0, 0.0))
        st, _ = hector.update(st, cloud, st.match_pose, cfg,
                              map_without_matching=jnp.asarray(True))
        st, _ = hector.update(st, cloud, st.match_pose, cfg)
        return np.asarray(st.maps), np.asarray(st.match_pose)

    m1, p1 = run()
    m2, p2 = run()
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(p1, p2)
