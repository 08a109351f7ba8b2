"""The Pallas GN matcher kernel (ops/pallas_match.py) against the gather
matcher, in interpret mode on the CPU.

The kernel reads the same f32 table values and runs the same per-beam math
as `matcher_mode="gather"`; only the order of the beam sums differs, so
poses must agree to 1e-4 (m, rad) and solve failures exactly.  The card
runs the same comparisons compiled (chip_smoke.py phase b).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slamnet_tpu.core import HectorConfig, SimConfig
from slamnet_tpu.core.scan import Scan
from slamnet_tpu.models import hector
from slamnet_tpu.ops import pallas_match
from slamnet_tpu.sim import default_field, lidar


def _boot_state(cfg, truth, angles, sim, scans=6, seed=0):
    fld = default_field()
    state = hector.init(cfg, truth)
    key = jax.random.PRNGKey(seed)
    for _ in range(scans):
        key, sub = jax.random.split(key)
        radii, valid = lidar.scan_revolution(fld, truth, angles,
                                             sim.max_scan_dist,
                                             sim.measure_error, sub)
        pts = jnp.stack([radii * jnp.cos(angles),
                         radii * jnp.sin(angles)], -1)
        state, _ = hector.update(state, Scan(pts, valid, jnp.zeros(3)),
                                 truth, cfg, map_without_matching=True)
    key, sub = jax.random.split(key)
    radii, valid = lidar.scan_revolution(fld, truth, angles,
                                         sim.max_scan_dist,
                                         sim.measure_error, sub)
    pts = jnp.stack([radii * jnp.cos(angles), radii * jnp.sin(angles)], -1)
    return state, Scan(pts, valid, jnp.zeros(3))


def _match(maps, scan, hint, cfg):
    return jax.jit(hector.match_with_stats, static_argnums=3)(
        maps, scan, hint, cfg)


def test_pallas_match_parity_vs_xla_onehot():
    # the reference is the gather matcher, whose semantics the kernel holds
    cfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4))
    sim = SimConfig()
    angles = jnp.asarray(lidar.revolution_angles(sim.num_scan_points))
    truth = jnp.asarray([20.0, 20.0, 0.0], jnp.float32)
    state, scan = _boot_state(cfg, truth, angles, sim)
    hint = truth + jnp.asarray([0.2, -0.15, 0.04])

    pose_g, stats_g = _match(state.maps, scan, hint, cfg)
    pk = dataclasses.replace(cfg, matcher_mode="pallas")
    pose_p, stats_p = _match(state.maps, scan, hint, pk)

    assert float(jnp.linalg.norm(pose_p[:2] - truth[:2])) < 0.05
    np.testing.assert_allclose(np.asarray(pose_p), np.asarray(pose_g),
                               atol=1e-4)
    assert int(stats_p.solve_failures) == int(stats_g.solve_failures) == 0
    assert int(stats_p.iterations) == int(stats_g.iterations) == 15
    np.testing.assert_allclose(float(stats_p.residual),
                               float(stats_g.residual), rtol=1e-3)
    np.testing.assert_allclose(float(stats_p.in_map_frac),
                               float(stats_g.in_map_frac), rtol=1e-6)


def test_pallas_match_empty_scan_returns_hint():
    cfg = dataclasses.replace(
        HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4)),
        matcher_mode="pallas")
    n = 400
    scan = Scan(jnp.zeros((n, 2), jnp.float32), jnp.zeros(n, bool),
                jnp.zeros(3, jnp.float32))
    maps = jnp.zeros(cfg.total_cells, jnp.float32)
    hint = jnp.asarray([20.0, 20.0, 0.5], jnp.float32)
    pose, _ = hector.match_with_stats(maps, scan, hint, cfg)
    np.testing.assert_allclose(np.asarray(pose), np.asarray(hint), atol=1e-6)


def test_pallas_match_with_guards_and_subsample():
    # the production knobs thread through: xy clamp, damping, subsample
    cfg = dataclasses.replace(
        HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4)),
        xy_step_clamp_px=10.0, gn_damping=0.1, match_subsample=4)
    sim = SimConfig()
    angles = jnp.asarray(lidar.revolution_angles(sim.num_scan_points))
    truth = jnp.asarray([20.0, 20.0, 0.0], jnp.float32)
    state, scan = _boot_state(cfg, truth, angles, sim, seed=2)
    hint = truth + jnp.asarray([0.15, 0.1, -0.03])
    pk = dataclasses.replace(cfg, matcher_mode="pallas")
    pose, stats = _match(state.maps, scan, hint, pk)
    assert float(jnp.linalg.norm(pose[:2] - truth[:2])) < 0.08
    pose_g, stats_g = _match(state.maps, scan, hint, cfg)
    np.testing.assert_allclose(np.asarray(pose), np.asarray(pose_g),
                               atol=1e-4)
    assert int(stats.solve_failures) == int(stats_g.solve_failures)


def test_pallas_match_rejects_early_exit():
    cfg = HectorConfig(num_levels=2, map_size=64, estimate_iterations=(3, 3),
                       matcher_mode="pallas", early_exit_tol=1e-3)
    scan = Scan(jnp.ones((16, 2), jnp.float32), jnp.ones(16, bool),
                jnp.zeros(3, jnp.float32))
    with pytest.raises(ValueError, match="early_exit_tol"):
        hector.match_with_stats(jnp.zeros(cfg.total_cells), scan,
                                jnp.asarray([3.0, 3.0, 0.0]), cfg)


@pytest.mark.parametrize("subsample", [1, 2, 4])
@pytest.mark.parametrize("n_beams", [181, 400, 1081])
def test_pallas_beam_padding(n_beams, subsample):
    """Any scanner width: the wrapper pads the (subsampled, lane-padded)
    beam axis to a power-of-two block, and padded beams change nothing."""
    n_match = -(-n_beams // subsample)
    lane_padded = hector._lane_pad(n_match)
    nb = pallas_match.block_beams(lane_padded)
    assert nb >= lane_padded and nb & (nb - 1) == 0 and nb < 2 * lane_padded

    cfg = HectorConfig(num_levels=2, map_size=64, map_resolution=0.25,
                       estimate_iterations=(3, 2), match_subsample=subsample)
    # a smooth synthetic map: an occupied ring of radius 5 m around (8, 8)
    levels = []
    for s, res in zip(cfg.level_sizes, cfg.level_resolutions):
        c = (np.arange(s) + 0.5) * res - 8.0
        r = np.hypot(c[None, :], c[:, None])
        levels.append((3.0 * np.exp(-((r - 5.0) / 0.4) ** 2) - 1.0).ravel())
    maps = jnp.asarray(np.concatenate(levels), jnp.float32)
    ang = np.linspace(-2.0, 2.0, n_beams, dtype=np.float32)
    pts = jnp.asarray(np.stack([5.0 * np.cos(ang), 5.0 * np.sin(ang)], -1))
    valid = jnp.asarray(np.arange(n_beams) % 7 != 3)
    scan = Scan(pts, valid, jnp.zeros(3, jnp.float32))
    hint = jnp.asarray([8.2, 7.9, 0.05], jnp.float32)

    pose_g, stats_g = _match(maps, scan, hint, cfg)
    pose_p, stats_p = _match(maps, scan, hint,
                             dataclasses.replace(cfg, matcher_mode="pallas"))
    np.testing.assert_allclose(np.asarray(pose_p), np.asarray(pose_g),
                               atol=1e-4)
    assert int(stats_p.solve_failures) == int(stats_g.solve_failures)
    np.testing.assert_allclose(float(stats_p.in_map_frac),
                               float(stats_g.in_map_frac), rtol=1e-6)


@pytest.mark.parametrize("platform,interpret", [("cpu", True),
                                                ("gpu", False),
                                                ("rocm", None),
                                                ("metal", None)])
def test_pallas_interpret_choice(platform, interpret):
    """Compiled on the GPU, interpreted only on the CPU, refused elsewhere."""
    if interpret is None:
        with pytest.raises(RuntimeError, match="no route"):
            pallas_match.interpret_for(platform)
    else:
        assert pallas_match.interpret_for(platform) is interpret
    assert pallas_match.interpret_for() is True     # the tests run on cpu


def test_pallas_step_lowers_to_triton_for_cuda(monkeypatch):
    """The per-scan step, lowered for CUDA, calls the kernel as a Triton
    custom call — the compiled route, no interpreter."""
    cfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4),
                       matcher_mode="pallas", dense_free_fill=True)
    state = hector.init(cfg, (20.0, 20.0, 0.0))
    scan = Scan(jnp.ones((400, 2), jnp.float32), jnp.ones(400, bool),
                jnp.zeros(3, jnp.float32))

    def step(state, scan):
        return hector.update(state, scan, state.match_pose, cfg)[0]

    monkeypatch.setattr(pallas_match, "interpret_for", lambda p=None: False)
    text = jax.jit(step).trace(state, scan).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count("xla.gpu.triton") == 1
    assert "gn_match" in text
