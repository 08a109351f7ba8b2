#!/usr/bin/env python
"""Smoke test of slamnet_tpu on one NVIDIA GPU: the quickest proof that the
system still starts, compiles and tracks on the card.

    python chip_smoke.py              # one card, phases a-e
    python chip_smoke.py --multichip  # only the sharded paths, on 4 cards

One process; each phase prints one line; any failure raises and exits
nonzero.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

  a. device and set-up: a GPU or nothing (never the CPU), the card's name
     and power limit, JAX's version, the compile cache;
  b. kernel parity at real widths: the Pallas matcher kernel against the
     gather matcher (3-level 400 px with 400 beams, the B=64 fleet, the
     128-px loop-closure match), the fill lookup against jnp.take,
     onehot_highest against gather, and the correlative scorer against the
     gather scorer.  References run at float32 "highest" matmul precision;
  c. the main path: the 512-scan Hector replay (bench.py's headline cell)
     in fixed, pallas, onehot_bf16_dense, gather_dense and pallas_dense,
     each within 1e-4 m of fixed's ATE, and 20 per-scan steps of
     __graft_entry__.entry with donated state;
  d. the other pipelines at bench size, each under its accuracy bound:
     CoreSLAM production and parity, graph-SLAM (gather, onehot_full,
     gather_full, pallas_full), the B=64 fleet (sub1, sub4_onehot_dense,
     sub4_gather_dense, sub4_pallas_dense) and 8192 particles
     (grid_dense);
  e. compile seconds, peak device memory, and the timings that chose the
     matcher kernel and the fill lookup (PERF.md).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

BOOT = 10
N_SCANS = 512
COMPILE_S = {}


def _line(phase: str, text: str) -> None:
    print(f"[{phase}] {text}", flush=True)


def _timed(name, fn, *args, reps=3):
    """(median seconds over `reps` warm calls, output); the first call's
    time (compile + one run) is recorded under `name` as set-up time."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    COMPILE_S[name] = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def _ate(poses, truth):
    pe = np.linalg.norm(np.asarray(poses)[..., :2] - truth[..., :2], axis=-1)
    return float(np.sqrt((pe ** 2).mean())), float(pe.max())


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _max_diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


# ----------------------------------------------------------------- data ----

def scan_log(traj, key_seed=0, num_beams=400):
    """Simulated 360-degree scans along `traj` (bench.py's generator)."""
    import jax
    import jax.numpy as jnp

    from slamnet_tpu.core import SimConfig
    from slamnet_tpu.sim import default_field, lidar
    sim = SimConfig()
    fld = default_field()
    angles = jnp.asarray(lidar.revolution_angles(num_beams))

    @jax.jit
    def gen(poses, key):
        keys = jax.random.split(key, poses.shape[0])
        return jax.vmap(lambda p, k: lidar.scan_revolution(
            fld, p, angles, sim.max_scan_dist, sim.measure_error, k))(
                poses, keys)

    radii, valids = gen(jnp.asarray(traj), jax.random.PRNGKey(key_seed))
    return radii, valids, angles


def cloud(r, v, angles):
    import jax.numpy as jnp

    from slamnet_tpu.core.scan import Scan
    return Scan(jnp.stack([r * jnp.cos(angles), r * jnp.sin(angles)], -1), v,
                jnp.zeros(3, jnp.float32))


# ------------------------------------------------------------ phase a ----

def phase_device():
    import jax

    from slamnet_tpu.runtime import gpu_card, require_gpu, setup_compile_cache
    rec = require_gpu()
    cache = setup_compile_cache()
    print(gpu_card(), flush=True)
    _line("a", f"device {rec} | jax {jax.__version__} | compile cache "
          f"{cache}")
    return rec


# ------------------------------------------------------------ phase b ----

def phase_parity(maps, sc, hint, fleet_case, loop_pair):
    """Kernel and lookup parity at the bench widths; the reference side is
    traced under float32 'highest' matmul precision, the production side
    at the default precision it runs with."""
    import jax
    import jax.numpy as jnp

    from slamnet_tpu.core import CoreSlamConfig, HectorConfig
    from slamnet_tpu.graph import frontend
    from slamnet_tpu.models import fleet, hector
    from slamnet_tpu.ops import correlate, holemap, score

    cfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4))

    def hmatch(mode):
        c = dataclasses.replace(cfg, matcher_mode=mode)
        return jax.jit(lambda m, s, h: hector.match_with_stats(m, s, h, c))

    with jax.default_matmul_precision("highest"):
        p_g, s_g = hmatch("gather")(maps, sc, hint)
        p_oh, s_oh = hmatch("onehot_highest")(maps, sc, hint)
    p_k, s_k = hmatch("pallas")(maps, sc, hint)
    d = _max_diff(p_k, p_g)
    _check(d <= 1e-4, f"hector kernel vs gather {d}")
    _check(int(s_k.solve_failures) == int(s_g.solve_failures),
           "hector solve_failures")
    lowered = hmatch("pallas").lower(maps, sc, hint).as_text()
    _check("xla.gpu.triton" in lowered, "kernel is not a Triton call")
    _line("b", f"hector 3x400 px, 400->512 beams: kernel vs gather max "
          f"|dpose| {d:.3g}, solve_failures {int(s_k.solve_failures)} == "
          f"{int(s_g.solve_failures)}, Triton custom call compiled")
    d_oh = _max_diff(p_oh, p_g)
    _check(d_oh == 0.0 and int(s_oh.solve_failures) == int(s_g.solve_failures),
           f"onehot_highest vs gather not bit-identical: {d_oh}")
    _line("b", "hector onehot_highest vs gather: bit-identical")

    flat, pts, valid, hints, fcfg = fleet_case
    cells = fleet.fleet_cells(fcfg)
    fm = jax.jit(lambda f, p, v, h, c: fleet._match_batch(f, cells, p, v, h, c),
                 static_argnums=4)
    with jax.default_matmul_precision("highest"):
        fp_g, fs_g = fm(flat, pts, valid, hints, fcfg)
    fp_k, fs_k = fm(flat, pts, valid, hints,
                    dataclasses.replace(fcfg, matcher_mode="pallas"))
    d = _max_diff(fp_k, fp_g)
    _check(d <= 1e-4, f"fleet kernel vs gather {d}")
    _check(bool((np.asarray(fs_k.solve_failures)
                 == np.asarray(fs_g.solve_failures)).all()),
           "fleet solve_failures")
    _line("b", f"fleet B={pts.shape[0]} (one program per robot): kernel vs "
          f"gather max |dpose| {d:.3g}, solve_failures equal")

    init = jnp.asarray([0.05, -0.03, 0.01], jnp.float32)

    def fmatch(mode):
        mc = frontend.ScanMatchConfig(matcher_mode=mode, dense_fill=True)
        return jax.jit(lambda a, b: frontend.match_scans(a, b, init, mc))
    ref_scan, qry_scan = loop_pair
    with jax.default_matmul_precision("highest"):
        r_g, q_g = fmatch("gather")(ref_scan, qry_scan)
    r_k, q_k = fmatch("pallas")(ref_scan, qry_scan)
    d = _max_diff(r_k, r_g)
    _check(d <= 1e-4, f"frontend kernel vs gather {d}")
    _line("b", f"loop-closure match 128 px x 20 it: kernel vs gather max "
          f"|drel| {d:.3g}, inliers {float(q_k.inlier_frac):.3f} vs "
          f"{float(q_g.inlier_frac):.3f}")

    rng = np.random.default_rng(1)
    table = jnp.asarray(rng.uniform(-10.0, 6000.0, 256), jnp.float32)
    table = table.at[::17].set(-1e9)          # the fills' "no beam" sentinel
    idx = jnp.asarray(rng.integers(0, 256, (400, 400)), jnp.int32)
    got = jax.jit(holemap.polar_lookup)(table, idx)
    _check(bool((np.asarray(got) == np.asarray(table)[np.asarray(idx)]).all()),
           "polar_lookup != take")
    _line("b", "fill lookup vs jnp.take at 400x400 over 256 bins "
          "(ranges to 6000 px): identical")

    # correlative scorer (f32 matmuls of small integers) vs the gather
    # scorer: integer-exact only if the card keeps those products exact
    ccfg = CoreSlamConfig()
    size, scale, W = ccfg.hole_map_size, ccfg.hole_scale, ccfg.corr_window
    R = W // 2
    hole = jnp.asarray(rng.integers(0, 65500, size * size), jnp.int32)
    pose = np.asarray([20.0, 20.0, 0.3])
    thetas = pose[2] + np.linspace(-0.5, 0.5, ccfg.corr_num_theta)
    r = rng.uniform(1.0, 12.0, 400)
    a = rng.uniform(-np.pi, np.pi, 400)
    p = np.stack([r * np.cos(a), r * np.sin(a)], -1)
    # keep points whose pixel snap is unambiguous for every heading, so the
    # comparison tests the contraction and not float rounding at a pixel edge
    px0 = pose[:2] * scale + 0.5
    keep = np.ones(400, bool)
    for th in thetas:
        c, s = np.cos(th) * scale, np.sin(th) * scale
        for q in (px0[0] + c * p[:, 0] - s * p[:, 1],
                  px0[1] + s * p[:, 0] + c * p[:, 1]):
            f = q - np.floor(q)
            keep &= (f > 1e-3) & (f < 1 - 1e-3)
    pts_c = jnp.asarray(p[keep], jnp.float32)
    val_c = jnp.ones(int(keep.sum()), bool)
    sums, nb = jax.jit(correlate.correlative_scores, static_argnums=(1, 2, 7))(
        hole, size, scale, pts_c, val_c, jnp.asarray(pose, jnp.float32),
        jnp.asarray(thetas, jnp.float32), W)
    iy, ix = np.meshgrid(np.arange(W), np.arange(W), indexing="ij")
    cand = np.stack([np.broadcast_to(pose[0] + (ix - R) / scale,
                                     (len(thetas), W, W)),
                     np.broadcast_to(pose[1] + (iy - R) / scale,
                                     (len(thetas), W, W)),
                     np.broadcast_to(thetas[:, None, None],
                                     (len(thetas), W, W))], -1)
    with jax.default_matmul_precision("highest"):
        s_ref, nb_ref = jax.jit(score.score_candidates,
                                static_argnums=(1, 2))(
            hole, size, scale, pts_c, val_c,
            jnp.asarray(cand.reshape(-1, 3), jnp.float32))
    bad = int((np.asarray(sums).reshape(-1) != np.asarray(s_ref)).sum()
              + (np.asarray(nb).reshape(-1) != np.asarray(nb_ref)).sum())
    _check(bad == 0, f"correlative scores differ in {bad} cells")
    _line("b", f"correlative scorer vs gather scorer: {sums.size} candidates "
          f"x {int(keep.sum())} points integer-exact")


# ------------------------------------------------------------ phase c ----

def hector_boot(radii, valids, angles, traj):
    """The bench's 3-level 400 px map after BOOT forced updates."""
    import jax
    import jax.numpy as jnp

    from slamnet_tpu.core import HectorConfig
    from slamnet_tpu.models import hector

    cfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4))

    @jax.jit
    def boot(state, radii, valids, poses):
        def body(st, inp):
            r, v, p = inp
            st, _ = hector.update(st, cloud(r, v, angles), p, cfg,
                                  map_without_matching=jnp.asarray(True))
            return st, None
        return jax.lax.scan(body, state, (radii, valids, poses))[0]

    return boot(hector.init(cfg, traj[0]), radii[:BOOT], valids[:BOOT],
                jnp.asarray(traj[:BOOT]))


def hector_replays(state, radii, valids, angles, traj):
    """The bench's 512-scan Hector replay in five modes from the booted
    state; returns {mode: (seconds, ate, max_err)}."""
    import jax

    from slamnet_tpu.core import HectorConfig
    from slamnet_tpu.models import hector

    cfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4))

    def make_replay(c):
        @jax.jit
        def replay(state, radii, valids):
            def body(st, inp):
                st, info = hector.update(st, cloud(*inp, angles),
                                         st.match_pose, c)
                return st, st.match_pose
            return jax.lax.scan(body, state, (radii, valids))
        return replay

    modes = {
        "fixed": cfg,
        "pallas": dataclasses.replace(cfg, matcher_mode="pallas"),
        "onehot_bf16_dense": dataclasses.replace(
            cfg, early_exit_tol=1e-3, matcher_mode="onehot_bf16",
            dense_free_fill=True),
        "gather_dense": dataclasses.replace(cfg, dense_free_fill=True),
        "pallas_dense": dataclasses.replace(cfg, matcher_mode="pallas",
                                            dense_free_fill=True),
    }
    out = {}
    for name, c in modes.items():
        secs, (_, poses) = _timed(f"hector:{name}", make_replay(c), state,
                                  radii[BOOT:], valids[BOOT:], reps=5)
        out[name] = (secs,) + _ate(poses, traj[BOOT:])
    ate_fixed = out["fixed"][1]
    for name, (secs, ate, mx) in out.items():
        _check(ate <= ate_fixed + 1e-4 and np.isfinite(mx),
               f"hector {name} ATE {ate} vs fixed {ate_fixed}")
    _line("c", f"hector {N_SCANS}-scan replay: " + ", ".join(
        f"{n} {N_SCANS / s:.1f} scans/s ATE {a:.5f} m"
        for n, (s, a, _) in out.items()) + " (each <= fixed + 1e-4)")
    return out


def entry_steps(radii, valids, angles, traj):
    """20 per-scan jitted steps of the driver entry with donated state."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    fn, (state, _, _) = graft.entry()
    step = jax.jit(fn, donate_argnums=0)
    state = state._replace(match_pose=jnp.asarray(traj[BOOT], jnp.float32))
    lat = []
    for t in range(BOOT, BOOT + 20):
        sc = cloud(radii[t], valids[t], angles)
        t0 = time.perf_counter()
        state = jax.block_until_ready(step(state, sc.points, sc.valid))
        lat.append(time.perf_counter() - t0)
    err = float(np.linalg.norm(np.asarray(state.match_pose)[:2]
                               - traj[BOOT + 19][:2]))
    _check(np.isfinite(np.asarray(state.maps)).all() and err < 0.1,
           f"entry steps error {err}")
    _line("c", f"entry(): 20 donated per-scan steps, final error {err:.4f} m, "
          f"first step {lat[0]:.2f} s (compile), then median "
          f"{np.median(lat[1:]) * 1e3:.3f} ms/scan host clock")


# ------------------------------------------------------------ phase d ----

def coreslam_runs(radii, valids, angles, traj, n=128):
    import jax

    from slamnet_tpu.core import CoreSlamConfig
    from slamnet_tpu.models import coreslam

    def run(name, cfg):
        @jax.jit
        def replay(state, radii, valids):
            def body(st, inp):
                st, _ = coreslam.update_cloud(st, cloud(*inp, angles),
                                              st.pose, cfg)
                return st, st.pose
            return jax.lax.scan(body, state, (radii, valids))
        state = coreslam.init(cfg, traj[0], key=jax.random.PRNGKey(1))
        secs, (_, poses) = _timed(f"coreslam:{name}", replay, state,
                                  radii[:n], valids[:n])
        ate, mx = _ate(poses, traj[:n])
        # tests/test_coreslam_e2e.py's loop bound
        _check(ate < 0.5 and mx < 1.0, f"coreslam {name} ATE {ate} max {mx}")
        return f"{name} {n / secs:.1f} scans/s ATE {ate:.4f} m"

    prod = dataclasses.replace(CoreSlamConfig(), search_mode="correlative",
                               dense_hole_fill=True, dense_obstacle_fill=True)
    _line("d", f"coreslam {n} scans: " + ", ".join(
        [run("production", prod),
         run("parity", CoreSlamConfig(num_candidates=4096))])
        + " (ATE < 0.5 m, max < 1 m)")


def graph_runs(angles_n=400, n_scans=512, bootstrap=12):
    import jax
    import jax.numpy as jnp

    from slamnet_tpu.core import HectorConfig, PoseGraphConfig
    from slamnet_tpu.graph import frontend
    from slamnet_tpu.models import graph_slam
    from slamnet_tpu.sim.trajectory import rect_revisit_trajectory

    hcfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4))
    gcfg = PoseGraphConfig()
    drive = rect_revisit_trajectory(num_loops=2)
    still = np.tile(np.asarray([20.0, 20.0, 0.0], np.float32), (bootstrap, 1))
    traj = np.concatenate([still, drive[:n_scans - bootstrap]])
    radii, valids, angles = scan_log(traj, key_seed=7, num_beams=angles_n)
    force = jnp.arange(n_scans) < bootstrap

    def run(name, h, m=None):
        @jax.jit
        def replay(state, radii, valids, force):
            def body(st, inp):
                r, v, f = inp
                st, _ = graph_slam.update(st, cloud(r, v, angles), h, gcfg,
                                          mcfg=m, map_without_matching=f)
                return st, st.hector.match_pose
            return jax.lax.scan(body, state, (radii, valids, force))
        state = graph_slam.init(h, gcfg, traj[0], angles_n)
        secs, (stf, poses) = _timed(f"graph:{name}", replay, state, radii,
                                    valids, force, reps=3)
        ate, _ = _ate(poses[bootstrap:], traj[bootstrap:])
        return dict(secs=secs, ate=ate, kf=int(stf.graph.num_nodes),
                    loops=int(stf.loop_count))

    dense = dict(dense_free_fill=True, dense_free_margin_px=0.5)
    out = {"gather": run("gather", hcfg)}
    for name, mode in (("onehot_full", "onehot_bf16"),
                       ("gather_full", "gather"),
                       ("pallas_full", "pallas")):
        out[name] = run(name, dataclasses.replace(hcfg, matcher_mode=mode,
                                                  **dense),
                        frontend.ScanMatchConfig(matcher_mode=mode,
                                                 dense_fill=True))
    base = out["gather"]
    for name, m in out.items():
        # bench.py's graph gate
        _check(m["ate"] <= base["ate"] * 1.15 and m["kf"] == base["kf"]
               and m["loops"] >= base["loops"] - 2, f"graph {name} {m}")
    _line("d", f"graph-SLAM {n_scans} scans: " + ", ".join(
        f"{n} {n_scans / m['secs']:.1f} scans/s ATE {m['ate']:.4f} m "
        f"{m['kf']} kf {m['loops']} loops" for n, m in out.items())
        + " (gate: <= 1.15x gather ATE, same keyframes, loops >= gather-2)")
    return out


def fleet_boot(radii, valids, angles, traj, B=64, T=64):
    """bench.py's fleet: B instances on phase-shifted slices of the bench
    log, after BOOT forced updates at the true poses."""
    import jax
    import jax.numpy as jnp

    from slamnet_tpu.core import HectorConfig
    from slamnet_tpu.models import fleet

    base = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4),
                        xy_step_clamp_px=10.0, max_match_jump=1.0)
    starts = np.linspace(0, radii.shape[0] - (T + BOOT), B).astype(int)
    r = jnp.stack([radii[s:s + T + BOOT] for s in starts], axis=1)
    v = jnp.stack([valids[s:s + T + BOOT] for s in starts], axis=1)
    tr = np.stack([traj[s:s + T + BOOT] for s in starts], axis=1)

    @jax.jit
    def boot_step(states, r1, v1, poses):
        states = states._replace(match_pose=poses)
        pts = jnp.stack([r1 * jnp.cos(angles)[None],
                         r1 * jnp.sin(angles)[None]], -1)
        return fleet.update_fleet(states, pts, v1, base,
                                  map_without_matching=True)[0]

    states = fleet.init_fleet(base, tr[0])
    for t in range(BOOT):
        states = boot_step(states, r[t], v[t], jnp.asarray(tr[t]))
    return states, r, v, tr, base


def fleet_runs(states, r, v, tr, base, angles):
    import jax

    from slamnet_tpu.models import fleet

    B, T = r.shape[1], r.shape[0] - BOOT

    def run(name, cfg):
        replay = jax.jit(lambda s, rr, vv: fleet.replay_fleet(
            s, rr, vv, angles, cfg))
        secs, (_, poses) = _timed(f"fleet:{name}", replay, states, r[BOOT:],
                                  v[BOOT:])
        ate, mx = _ate(poses, tr[BOOT:])
        return dict(rate=T * B / secs, ate=ate, max=mx)

    sub4 = dict(match_subsample=4, dense_free_fill=True)
    out = {"sub1": run("sub1", base),
           "sub4_onehot_dense": run("sub4_onehot_dense", dataclasses.replace(
               base, matcher_mode="onehot_bf16", **sub4)),
           "sub4_gather_dense": run("sub4_gather_dense", dataclasses.replace(
               base, **sub4)),
           "sub4_pallas_dense": run("sub4_pallas_dense", dataclasses.replace(
               base, matcher_mode="pallas", **sub4))}
    bound = 2.0 * out["sub1"]["ate"]                  # bench.py's fleet gate
    for name, m in out.items():
        _check(m["ate"] <= bound, f"fleet {name} {m} bound {bound}")
    _line("d", f"fleet B={B} T={T}: " + ", ".join(
        f"{n} {m['rate']:.1f} instance-scans/s ATE {m['ate']:.4f} m"
        for n, m in out.items()) + f" (gate: ATE <= {bound:.4f} m)")
    return out


def particle_run(radii, valids, angles, traj, n=64):
    import jax

    from slamnet_tpu.core import CoreSlamConfig, ParticleConfig
    from slamnet_tpu.models import particle

    pcfg = dataclasses.replace(ParticleConfig(), scorer="grid", top_k=16,
                               refine_candidates=32, refine_subsample=4)
    ccfg = dataclasses.replace(CoreSlamConfig(), dense_hole_fill=True,
                               dense_obstacle_fill=True)

    @jax.jit
    def replay(state, radii, valids):
        def body(st, inp):
            st, _ = particle.update(st, cloud(*inp, angles), st.pose, ccfg,
                                    pcfg)
            return st, st.pose
        return jax.lax.scan(body, state, (radii, valids))

    state = particle.init(ccfg, pcfg, traj[0], key=jax.random.PRNGKey(2))
    secs, (_, poses) = _timed("particle:grid_dense", replay, state,
                              radii[:n], valids[:n])
    ate, mx = _ate(poses, traj[:n])
    err = np.abs(np.asarray(poses)[:, 2] - traj[:n, 2])
    head = float(np.minimum(err, 2 * np.pi - err).max())
    # tests/test_particle.py's loop bound
    _check(mx < 1.0 and head < np.radians(10.0),
           f"particles max {mx} heading {head}")
    _line("d", f"particles {pcfg.num_particles} grid_dense {n} scans: "
          f"{n / secs:.1f} scans/s ATE {ate:.4f} m max {mx:.3f} m "
          f"(max < 1 m, heading < 10 deg)")


# ------------------------------------------------------------ phase e ----

def kernel_timings(maps, sc, hint, hector_out, graph_out, fleet_out):
    """Matcher kernel against XLA's matchers, and the fill lookup against
    the one-hot form it replaced, on device (no host dispatch inside)."""
    import jax
    import jax.numpy as jnp

    from slamnet_tpu.core import HectorConfig
    from slamnet_tpu.models import hector
    from slamnet_tpu.ops import logodds

    cfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4))
    hints = hint[None] + jnp.linspace(-0.05, 0.05, 256)[:, None]

    def matches(mode):
        c = dataclasses.replace(cfg, matcher_mode=mode)

        @jax.jit
        def many(m, s, hs):
            return jax.lax.map(lambda h: hector.match_with_stats(m, s, h, c)[0],
                               hs)
        secs, _ = _timed(f"match:{mode}", many, maps, sc, hints, reps=5)
        return secs / hints.shape[0] * 1e6

    us = {m: matches(m) for m in ("gather", "onehot_bf16", "pallas")}
    _line("e", "one 3-level match on device: " + ", ".join(
        f"{m} {u:.2f} us" for m, u in us.items()))

    def onehot_lookup(table, idx):
        # the removed one-hot form: table[idx] as a [cells, bins] one-hot
        # matmul against the table's three 8-bit integer slices
        q = jnp.clip((table + 1024.0) * 4096.0, 0.0,
                     2.0 ** 24 - 1).astype(jnp.int32)
        t3 = jnp.stack([q >> 16, (q >> 8) & 255, q & 255], 1)
        oh = (idx.reshape(-1, 1) == jnp.arange(table.shape[0])).astype(
            jnp.bfloat16)
        sel = jnp.dot(oh, t3.astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)
        return (sel @ jnp.asarray([16.0, 1 / 16.0, 1 / 4096.0])
                - 1024.0).reshape(idx.shape)

    def fills(lookup):
        orig = logodds.polar_lookup
        logodds.polar_lookup = lookup
        try:
            @jax.jit
            def many(g, s, poses):
                return jax.lax.map(lambda p: logodds.update_occupancy_dense(
                    g, 400, s.points, s.valid, p, jnp.zeros(2), 10.0,
                    cfg.log_odds_free, cfg.log_odds_occupied), poses)
            secs, out = _timed(f"fill:{lookup.__name__}", many,
                               maps[:400 * 400], sc, hints[:64], reps=5)
        finally:
            logodds.polar_lookup = orig
        return secs / 64 * 1e6, out

    us_take, a = fills(logodds.polar_lookup)
    us_oh, b = fills(onehot_lookup)
    _line("e", f"400x400 dense occupancy fill on device: gather lookup "
          f"{us_take:.2f} us, one-hot lookup {us_oh:.2f} us (maps differ in "
          f"{int((np.asarray(a) != np.asarray(b)).sum())} cells)")

    h = {n: N_SCANS / s for n, (s, _, _) in hector_out.items()}
    g = {n: N_SCANS / m["secs"] for n, m in graph_out.items()}
    f = {n: m["rate"] for n, m in fleet_out.items()}
    _line("e", "matcher kernel vs XLA's gather matcher end to end, all else "
          f"equal: hector pallas {h['pallas']:.1f} vs fixed {h['fixed']:.1f}"
          f" scans/s, pallas_dense {h['pallas_dense']:.1f} vs gather_dense "
          f"{h['gather_dense']:.1f}; graph pallas_full {g['pallas_full']:.1f}"
          f" vs gather_full {g['gather_full']:.1f}; fleet sub4_pallas_dense "
          f"{f['sub4_pallas_dense']:.1f} vs sub4_gather_dense "
          f"{f['sub4_gather_dense']:.1f} instance-scans/s")


def phase_sizes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    slow = sorted(COMPILE_S.items(), key=lambda kv: -kv[1])[:6]
    _line("e", f"compile+first-run seconds total {sum(COMPILE_S.values()):.1f}"
          f" (largest: " + ", ".join(f"{k} {v:.1f}" for k, v in slow)
          + f"); peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


# ------------------------------------------------------------ single ----

def single_card():
    import jax.numpy as jnp

    from slamnet_tpu.sim.trajectory import loop_trajectory

    traj = loop_trajectory(speed=0.3)[:N_SCANS + BOOT]
    radii, valids, angles = scan_log(traj)
    state = hector_boot(radii, valids, angles, traj)
    fleet_states, r, v, tr, fcfg = fleet_boot(radii, valids, angles, traj)

    sc = cloud(radii[BOOT], valids[BOOT], angles)
    hint = jnp.asarray(traj[BOOT], jnp.float32) + jnp.asarray(
        [0.1, -0.08, 0.03])
    pts = jnp.stack([r[BOOT] * jnp.cos(angles)[None],
                     r[BOOT] * jnp.sin(angles)[None]], -1)
    fleet_case = (fleet_states.maps, pts, v[BOOT],
                  fleet_states.match_pose + 0.02, fcfg)
    loop_pair = (cloud(radii[20], valids[20], angles),
                 cloud(radii[23], valids[23], angles))
    phase_parity(state.maps, sc, hint, fleet_case, loop_pair)

    hector_out = hector_replays(state, radii, valids, angles, traj)
    entry_steps(radii, valids, angles, traj)
    coreslam_runs(radii, valids, angles, traj)
    graph_out = graph_runs()
    fleet_out = fleet_runs(fleet_states, r, v, tr, fcfg, angles)
    particle_run(radii, valids, angles, traj)
    kernel_timings(state.maps, sc, hint, hector_out, graph_out, fleet_out)
    phase_sizes()


# --------------------------------------------------------- multichip ----

def multichip():
    """The sharded paths on 4 cards, each against the dense single-device
    pipeline on the same scans."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    from slamnet_tpu.core import CoreSlamConfig, HectorConfig, PoseGraphConfig
    from slamnet_tpu.core.scan import Scan
    from slamnet_tpu.models import (coreslam, coreslam_sharded, fleet,
                                    graph_slam, graph_slam_sharded, hector,
                                    hector_sharded)
    from slamnet_tpu.parallel import make_mesh
    from slamnet_tpu.sim.trajectory import loop_trajectory, rect_drive_trajectory

    _check(len(jax.devices()) == 4, f"--multichip needs 4 GPUs: {jax.devices()}")
    nb = 400
    cfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4))
    n_steps = 32
    traj = loop_trajectory(speed=0.3)[:n_steps]
    pts, valids = graft._scan_log(traj, nb)

    @jax.jit
    def dense_step(st, p, v, hint, force):
        return hector.update(st, Scan(p, v, jnp.zeros(3, jnp.float32)), hint,
                             cfg, map_without_matching=force)

    dense = hector.init(cfg, traj[0])
    d_poses = []
    for t in range(n_steps):
        hint = jnp.asarray(traj[t]) if t < 6 else dense.match_pose
        dense, _ = dense_step(dense, pts[t], valids[t], hint,
                              jnp.asarray(t < 6))
        if t < 6:
            dense = dense._replace(match_pose=jnp.asarray(traj[t], jnp.float32))
        d_poses.append(np.asarray(dense.match_pose))

    for shape in ({"tile": 2, "search": 2}, {"tile": 4, "search": 1}):
        mesh = make_mesh(shape)
        st = hector_sharded.init(mesh, cfg, traj[0])
        step = hector_sharded.make_step(mesh, cfg, nb)
        s_poses = []
        for t in range(n_steps):
            if t < 6:
                st = st._replace(match_pose=jnp.asarray(traj[t], jnp.float32))
            st, _ = step(st, pts[t], valids[t], jnp.asarray(t < 6))
            s_poses.append(np.asarray(st.match_pose))
        d = _max_diff(s_poses, d_poses)
        maps_d = _max_diff(hector_sharded.unshard_maps(st, cfg), dense.maps)
        # tests/test_hector_sharded.py's replay tolerances
        _check(d <= 5e-3 and maps_d < 1e-2, f"hector {shape}: {d} {maps_d}")
        _line("m", f"hector beam/tile sharded {shape} {n_steps} steps vs "
              f"dense: max |dpose| {d:.3g}, max |dmap| {maps_d:.3g}")

        ccfg = dataclasses.replace(CoreSlamConfig(), search_mode="correlative",
                                   dense_hole_fill=True,
                                   dense_obstacle_fill=True)
        cd = coreslam.init(ccfg, traj[0], key=jax.random.PRNGKey(7))
        cs = coreslam_sharded.shard_state(mesh, cd, ccfg)
        cstep = coreslam_sharded.make_step(mesh, ccfg)
        cdstep = jax.jit(lambda s, p, v: coreslam.update_cloud(
            s, Scan(p, v, jnp.zeros(3, jnp.float32)), s.pose, ccfg))
        for t in range(n_steps):
            cd, di = cdstep(cd, pts[t], valids[t])
            cs, si = cstep(cs, pts[t], valids[t], cs.pose)
            _check(bool((np.asarray(cs.pose) == np.asarray(cd.pose)).all())
                   and int(si.best_sum) == int(di.best_sum),
                   f"coreslam {shape} step {t} not bit-exact")
        back = coreslam_sharded.to_dense(cs)
        _check(bool((np.asarray(back.hole_map)
                     == np.asarray(cd.hole_map)).all()
                    and (np.asarray(back.obstacle_map)
                         == np.asarray(cd.obstacle_map)).all()),
               f"coreslam {shape} maps not bit-exact")
        _line("m", f"coreslam production sharded {shape} {n_steps} steps vs "
              f"dense: poses, best sums and maps bit-exact")

    mesh = make_mesh({"tile": 2, "search": 2})
    gcfg = PoseGraphConfig(max_keyframes=32, max_edges=64, keyframe_dist=0.5,
                           keyframe_angle=0.6, loop_closure_radius=1.5)
    gtraj = np.concatenate([np.tile(np.asarray([20.0, 20.0, 0.0], np.float32),
                                    (6, 1)), rect_drive_trajectory()])
    gpts, gvalids = graft._scan_log(gtraj, nb, key_seed=3)
    gd = graph_slam.init(cfg, gcfg, gtraj[0], nb)
    gs = graph_slam_sharded.init(mesh, cfg, gcfg, gtraj[0], nb)
    gstep = graph_slam_sharded.make_step(mesh, cfg, gcfg, nb, sep_capacity=8)
    gdstep = jax.jit(lambda s, p, v, f: graph_slam.update(
        s, Scan(p, v, jnp.zeros(3, jnp.float32)), cfg, gcfg,
        map_without_matching=f))
    g_d, g_s, overflow = [], [], 0
    for t in range(gtraj.shape[0]):
        gd, _ = gdstep(gd, gpts[t], gvalids[t], jnp.asarray(t < 5))
        gs, gi = gstep(gs, gpts[t], gvalids[t], jnp.asarray(t < 5))
        overflow = max(overflow, int(gi.sep_overflow))
        g_d.append(np.asarray(gd.hector.match_pose))
        g_s.append(np.asarray(gs.match_pose))
    nkf = int(gd.graph.num_nodes)
    d_track = _max_diff(g_s, g_d)
    d_kf = _max_diff(gs.graph.poses[:nkf], gd.graph.poses[:nkf])
    # tests/test_graph_slam.py's sharded-vs-dense tolerances
    _check(overflow == 0 and int(gs.loop_count) >= 1
           and int(gs.graph.num_nodes) == nkf
           and int(gs.graph.num_edges) == int(gd.graph.num_edges)
           and d_track <= 2e-2 and d_kf <= 2e-2,
           f"graph: loops {int(gs.loop_count)} kf {int(gs.graph.num_nodes)}/"
           f"{nkf} track {d_track} kf {d_kf}")
    _line("m", f"graph-SLAM sharded (Schur solve) tile=2,search=2 "
          f"{gtraj.shape[0]} steps vs dense: {nkf} keyframes, "
          f"{int(gs.loop_count)} loops, max |dpose| {d_track:.3g}, "
          f"keyframes {d_kf:.3g}")

    B, T = 64, 16
    mesh = make_mesh({"search": 4})
    fcfg = dataclasses.replace(cfg, xy_step_clamp_px=10.0, max_match_jump=1.0)
    starts = np.linspace(0, n_steps - T - 1, B).astype(int)
    fp = jnp.stack([pts[s:s + T] for s in starts], axis=1)
    fv = jnp.stack([valids[s:s + T] for s in starts], axis=1)
    ftr = np.stack([traj[s:s + T] for s in starts], axis=1)
    f_d = fleet.init_fleet(fcfg, ftr[0])
    f_s = f_d
    fstep = fleet.make_fleet_step(mesh, fcfg)
    fdstep = jax.jit(lambda s, p, v, f: fleet.update_fleet(s, p, v, fcfg, f))
    for t in range(T):
        if t < 4:                    # bootstrap at the true poses
            truth = jnp.asarray(ftr[t], jnp.float32)
            f_d = f_d._replace(match_pose=truth)
            f_s = f_s._replace(match_pose=truth)
        f_d, _ = fdstep(f_d, fp[t], fv[t], jnp.asarray(t < 4))
        f_s, _ = fstep(f_s, fp[t], fv[t], jnp.asarray(t < 4))
    d = _max_diff(f_s.match_pose, f_d.match_pose)
    dm = _max_diff(f_s.maps, f_d.maps)
    _check(d <= 5e-3 and dm < 1e-2, f"fleet sharded {d} {dm}")
    _line("m", f"fleet B={B} instance-sharded over 4 cards {T} steps vs one "
          f"device: max |dpose| {d:.3g}, max |dmap| {dm:.3g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the sharded paths, on 4 GPUs")
    args = ap.parse_args(argv)
    rec = phase_device()
    if args.multichip:
        multichip()
    else:
        single_card()
    print(json.dumps({"ok": True, "device": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
