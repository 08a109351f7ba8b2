"""Dense polygon-fill occupancy mode: consistency with line mode + e2e tracking."""
import math

import jax
import jax.numpy as jnp
import numpy as np

from slamnet_tpu.core import HectorConfig, SimConfig
from slamnet_tpu.core.scan import Scan
from slamnet_tpu.ops import logodds
from slamnet_tpu.models import hector
from slamnet_tpu.sim import default_field, lidar
from slamnet_tpu.sim.trajectory import loop_trajectory


def test_dense_fill_superset_of_lines_and_same_occ():
    # smooth range profile (a rotating lidar in a room) — the dense mode's
    # conservative bin-min is only tight for smooth fields; wildly random
    # radii are out of its contract
    width, scale = 128, 3.2
    pose = jnp.asarray([20.0, 20.0, 0.3], jnp.float32)
    n = 200
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = 10.0 + 4.0 * np.sin(3 * ang)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    lo0 = jnp.zeros(width * width, jnp.float32)
    lof, loo = -0.405, 2.197

    lines = np.asarray(logodds.update_occupancy(
        lo0, width, jnp.asarray(pts), jnp.ones(n, bool), pose,
        jnp.zeros(2, jnp.float32), scale, lof, loo))
    # margin 0.5 here: this test checks the GEOMETRIC polygon contract
    # (free-coverage vs line mode); the production default margin (0.75,
    # wall-erosion guard) deliberately trims cells near measured surfaces —
    # see test_dense_fill_margin_leaves_wall_moat
    dense = np.asarray(logodds.update_occupancy_dense(
        lo0, width, jnp.asarray(pts), jnp.ones(n, bool), pose,
        jnp.zeros(2, jnp.float32), scale, lof, loo, free_margin_px=0.5))

    # identical occupied endpoints
    np.testing.assert_array_equal(lines > 1.0, dense > 1.0)
    # free marking: dense covers most line-marked free cells (the conservative
    # bin-min truncates only the outermost cells of beams sharing a bin with a
    # shorter neighbor — the documented contract)
    line_free = lines < -0.1
    dense_free = dense < -0.1
    covered = (line_free & dense_free).sum() / max(line_free.sum(), 1)
    assert covered > 0.75, covered
    # comparable total free evidence (fills between beams, trims endpoint tails)
    assert dense_free.sum() > 0.8 * line_free.sum()
    # dense never marks an occupied endpoint free
    assert not (dense_free & (lines > 1.0)).any()


def test_dense_fill_no_beams_is_noop():
    width = 32
    lo0 = jnp.ones(width * width, jnp.float32) * 0.5
    out = logodds.update_occupancy_dense(
        lo0, width, jnp.zeros((4, 2), jnp.float32), jnp.zeros(4, bool),
        jnp.asarray([5.0, 5.0, 0.0]), jnp.zeros(2), 1.0, -0.4, 2.2)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(lo0))


def test_hector_tracks_with_dense_fill():
    cfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4),
                       dense_free_fill=True)
    sim = SimConfig()
    fld = default_field()
    angles = jnp.asarray(lidar.revolution_angles(sim.num_scan_points))
    traj = loop_trajectory(speed=0.3)[:150]
    key = jax.random.PRNGKey(0)
    state = hector.init(cfg, traj[0])

    @jax.jit
    def step(state, real_pose, key, boot):
        radii, valid = lidar.scan_revolution(fld, real_pose, angles,
                                             sim.max_scan_dist,
                                             sim.measure_error, key)
        pts = jnp.stack([radii * jnp.cos(angles), radii * jnp.sin(angles)], -1)
        return hector.update(state, Scan(pts, valid, jnp.zeros(3, jnp.float32)),
                             state.match_pose, cfg, map_without_matching=boot)

    errs = []
    for t in range(traj.shape[0]):
        key, sub = jax.random.split(key)
        state, _ = step(state, jnp.asarray(traj[t]), sub, jnp.asarray(t < 10))
        errs.append(np.asarray(state.match_pose) - traj[t])
    errs = np.asarray(errs)
    assert np.linalg.norm(errs[:, :2], axis=1).max() < 0.5
    assert np.abs(errs[:, 2]).max() < math.radians(5.0)


def test_dense_fill_margin_leaves_wall_moat():
    # the wall-erosion guard: with the default margin, cells within
    # free_margin_px in front of a measured surface stay UNMARKED (moat),
    # and uncovered angular sectors are never marked free (partial FoV)
    width, scale = 128, 3.2
    pose = jnp.asarray([20.0, 20.0, 0.0], jnp.float32)
    n = 90                               # front-facing 180-degree fan
    ang = np.linspace(-np.pi / 2, np.pi / 2, n).astype(np.float32)
    r = np.full(n, 12.0, np.float32)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    lo0 = jnp.zeros(width * width, jnp.float32)
    out = np.asarray(logodds.update_occupancy_dense(
        lo0, width, jnp.asarray(pts), jnp.ones(n, bool), pose,
        jnp.zeros(2, jnp.float32), scale, -0.4, 2.2,
        free_margin_px=2.0)).reshape(width, width)
    free = out < -0.1
    yy, xx = np.mgrid[0:width, 0:width]
    bx, by = 20.0 * scale, 20.0 * scale
    rc = np.hypot(xx - bx, yy - by)
    bear = np.arctan2(yy - by, xx - bx)
    r_px = 12.0 * scale
    in_fan = np.abs(bear) < np.radians(85)
    # moat: nothing free just in front of the measured surface (band width
    # = margin 2.0 minus the +/-0.71 px endpoint-rounding slop)
    assert not (free & in_fan & (rc > r_px - 1.2) & (rc < r_px)).any()
    # interior still free
    assert (free & in_fan & (rc > 5) & (rc < r_px - 4.0)).sum() > 1000
    # rear half (uncovered sector): nothing free at all
    rear = np.abs(bear) > np.radians(95)
    assert not (free & rear).any()


def test_dense_fill_survives_adversarial_log():
    # VERDICT r04 item 4 done-criterion: the adversarial 180-degree log
    # (slips, dropout, drifting odometry) replayed with the dense fill stays
    # within 1.5x of line-fill ATE.  At margin 0.5 (the round-4 behavior)
    # walls erode and a slip locks the matcher into a false minimum (0.208
    # rms, 6x line); the default free margin fixes it (PERF.md).
    import os
    import dataclasses
    from slamnet_tpu.io import datasets

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "data",
        "adversarial_180.clf")
    log = datasets.read_carmen(path)
    T = log.ranges.shape[0]
    pts_all = jnp.asarray(datasets.log_points(log))
    valid = jnp.asarray(log.valid)
    # recenter: first odometry pose -> map center (as examples/replay_dataset)
    offset = log.odometry[0, :2] - 20.0
    odo = log.odometry.copy()
    odo[:, :2] -= offset[None, :]
    truth = log.truth.copy()
    truth[:, :2] -= offset[None, :]
    deltas = np.zeros_like(odo)
    deltas[1:] = odo[1:] - odo[:-1]
    deltas[:, 2] = (deltas[:, 2] + np.pi) % (2 * np.pi) - np.pi

    def run(dense):
        hcfg = dataclasses.replace(
            HectorConfig(), num_levels=3, estimate_iterations=(7, 4, 4),
            map_resolution=0.1, xy_step_clamp_px=10.0, max_match_jump=1.0,
            gn_damping=0.1, dense_free_fill=dense)

        @jax.jit
        def replay(st, pts, valid, force, dl, od):
            def body(st, inp):
                p, v, f, d, o = inp
                st, _ = hector.update(
                    st, Scan(p, v, jnp.zeros(3, jnp.float32)),
                    st.match_pose + d, hcfg, f)
                st = st._replace(match_pose=jnp.where(f, o, st.match_pose))
                return st, st.match_pose
            return jax.lax.scan(body, st, (pts, valid, force, dl, od))

        st = hector.init(hcfg, odo[0])
        force = jnp.arange(T) < 10
        _, track = replay(st, pts_all, valid, force,
                          jnp.asarray(deltas, jnp.float32),
                          jnp.asarray(odo, jnp.float32))
        pe = np.linalg.norm(np.asarray(track)[:, :2] - truth[:, :2], axis=1)
        return float(np.sqrt((pe ** 2).mean())), float(pe.max())

    rms_line, max_line = run(False)
    rms_dense, max_dense = run(True)
    assert rms_line < 0.06, rms_line              # the known-good baseline
    assert rms_dense < 1.5 * rms_line, (rms_dense, rms_line)
    assert max_dense < max_line, (max_dense, max_line)   # slips absorbed


def test_polar_lookup_equals_take_at_any_range():
    """The one lookup every dense fill uses is table[idx], exactly: ranges
    far above 3072 px and the -1e9 "no beam" sentinel come back unchanged
    (the removed one-hot form clipped both)."""
    from slamnet_tpu.ops import holemap
    rng = np.random.default_rng(0)
    table = rng.uniform(-50.0, 20000.0, 256).astype(np.float32)
    table[::9] = -1e9
    table[5] = 3072.0
    table[6] = 123456.75
    idx = rng.integers(0, 256, (160, 160)).astype(np.int32)
    got = np.asarray(jax.jit(holemap.polar_lookup)(jnp.asarray(table),
                                                   jnp.asarray(idx)))
    np.testing.assert_array_equal(got, np.take(table, idx))
    assert got.dtype == np.float32 and got.shape == idx.shape
