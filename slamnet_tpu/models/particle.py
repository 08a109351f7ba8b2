"""Batched particle SLAM — a layer with no reference counterpart.

BASELINE.json config 4: "8k-particle vmapped CoreSLAM scoring + top-k refine on
one chip".  Where CoreSLAM perturbs one search pose (CoreSLAMProcessor.cs:624-653),
this layer maintains a persistent population of P pose hypotheses:

  1. propagate: every particle moves by the odometry delta + motion noise;
  2. score:     ONE fused score_candidates call over all P particles
                (the same kernel as the Monte-Carlo search — P2 scaled up);
  3. refine:    the top-k particles each spawn R local perturbations, scored in
                a second fused [k*R] batch; each survivor keeps its best;
  4. estimate:  the best refined particle;
  5. resample:  systematic resampling from softmax(-score/T) when the effective
                sample size drops below the configured fraction;
  6. map:       hole/obstacle maps updated at the estimate (same kernels as
                models.coreslam).

Everything is fixed-shape and fused; a scan step is one jitted program.

Scoring backends (ParticleConfig.scorer; measured in PERF.md): "exact"
runs the [P, N] gather batch above (the BASELINE config-4 contract; gather-
rate bound at 8k particles); "grid" reuses the correlative count-grid x
shifted-planes matmul scorer (ops/correlate) — one grid evaluation per scan,
every particle reads its nearest (theta-bin, pixel-shift) cell, and the
grid's sub-pixel argmin joins the top-k refine pool.  Beam strides
(score_subsample / refine_subsample) trade gathers for precision coarse-to-
fine; mixed-scale score write-backs are rescaled by the valid-beam ratio.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..core.config import CoreSlamConfig, ParticleConfig
from ..core.geometry import normalize_angle
from ..core.scan import Scan
from ..ops import correlate, holemap, obstacle, score
from . import coreslam


class ParticleState(NamedTuple):
    particles: jnp.ndarray      # f32[P, 3]
    scores: jnp.ndarray         # i32[P] — last scan's pixel sums (lower=better)
    hole_map: jnp.ndarray       # i32[S*S]
    obstacle_map: jnp.ndarray   # i8[OS, OS]
    pose: jnp.ndarray           # f32[3] current best estimate
    last_odometry: jnp.ndarray  # f32[3]
    scan_count: jnp.ndarray     # i32[]
    key: jnp.ndarray


class ParticleInfo(NamedTuple):
    best_sum: jnp.ndarray       # i32
    ess: jnp.ndarray            # f32 effective sample size
    resampled: jnp.ndarray      # bool


def init(ccfg: CoreSlamConfig, pcfg: ParticleConfig, start_pose,
         key=None) -> ParticleState:
    if key is None:
        key = jax.random.PRNGKey(0)
    s = ccfg.hole_map_size
    os_ = ccfg.obstacle_map_size
    start = jnp.asarray(start_pose, jnp.float32)
    return ParticleState(
        particles=jnp.tile(start[None], (pcfg.num_particles, 1)),
        scores=jnp.zeros(pcfg.num_particles, jnp.int32),
        hole_map=jnp.full((s * s,), coreslam.HOLE_INIT, jnp.int32),
        obstacle_map=jnp.full((os_, os_), ccfg.unmapped_obstacle_hits, jnp.int8),
        pose=start,
        last_odometry=jnp.zeros(3, jnp.float32),
        scan_count=jnp.zeros((), jnp.int32),
        key=key,
    )


def _score(state, cfg: CoreSlamConfig, points, valid, poses):
    sums, nb = score.score_candidates(state.hole_map, cfg.hole_map_size,
                                      cfg.hole_scale, points, valid, poses)
    return jnp.where(nb > 0, sums, score.INT32_MAX)


def _grid_score(state, ccfg: CoreSlamConfig, cloud: Scan, search, poses):
    """Correlative population scoring: ONE count-grid evaluation of the
    (theta-bin x pixel-shift) neighborhood around `search`, then every
    particle reads its nearest cell — replaces the [P, N] gather batch
    with a [P]-sized lookup.

    Returns (eff i32[P] — int-max outside the grid, grid_pose f32[3],
    grid_sum i32): grid_pose is the sub-pixel refined grid argmin, injected
    into the refine stage so the estimate keeps correlative accuracy."""
    span = ccfg.corr_theta_span or 3.0 * ccfg.sigma_theta
    K, W = ccfg.corr_num_theta, ccfg.corr_window
    R = W // 2
    scale = ccfg.hole_scale
    thetas = search[2] + jnp.linspace(-span, span, K)
    sums, nb = correlate.correlative_scores(
        state.hole_map, ccfg.hole_map_size, scale, cloud.points, cloud.valid,
        search, thetas, W)
    grid = jnp.where(nb > 0, sums, score.INT32_MAX)          # [K, W, W]
    grid_pose, grid_sum = correlate.refine_from_scores(
        grid, search, scale, W, K, span)

    dth = 2.0 * span / max(K - 1, 1)
    k = jnp.round(normalize_angle(poses[:, 2] - search[2]) / dth
                  + (K - 1) / 2.0).astype(jnp.int32)
    ix = jnp.round((poses[:, 0] - search[0]) * scale).astype(jnp.int32) + R
    iy = jnp.round((poses[:, 1] - search[1]) * scale).astype(jnp.int32) + R
    inside = ((k >= 0) & (k < K) & (ix >= 0) & (ix < W)
              & (iy >= 0) & (iy < W))
    flat = (jnp.clip(k, 0, K - 1) * W + jnp.clip(iy, 0, W - 1)) * W \
        + jnp.clip(ix, 0, W - 1)
    eff = jnp.take(grid.reshape(-1), flat)
    return jnp.where(inside, eff, score.INT32_MAX), grid_pose, grid_sum


def update(state: ParticleState, cloud: Scan, odometry_pose,
           ccfg: CoreSlamConfig,
           pcfg: ParticleConfig) -> Tuple[ParticleState, ParticleInfo]:
    odo = jnp.asarray(odometry_pose, jnp.float32)
    key, k_prop, k_ref, k_res = jax.random.split(state.key, 4)
    p = pcfg.num_particles

    # 1. propagate with the odometry delta prior (CoreSLAMProcessor.cs:728)
    delta = odo - state.last_odometry
    noise_xy = jax.random.normal(k_prop, (p, 2)) * ccfg.sigma_xy
    noise_th = jax.random.normal(jax.random.fold_in(k_prop, 1), (p, 1)) \
        * ccfg.sigma_theta
    prop = state.particles + delta[None, :] + jnp.concatenate(
        [noise_xy, noise_th], axis=1)
    # particle 0 carries the unperturbed prior
    prop = prop.at[0].set(state.pose + delta)

    # 2. score the whole population in one fused batch ("exact": the
    #    config-4 [P, N] gather batch, optionally on a beam stride; "grid":
    #    one correlative score grid + a [P] cell lookup — see _grid_score)
    ss = max(1, pcfg.score_subsample)
    if pcfg.scorer == "grid":
        eff, grid_pose, _ = _grid_score(state, ccfg, cloud,
                                        state.pose + delta, prop)
    elif pcfg.scorer == "exact":
        eff = _score(state, ccfg, cloud.points[::ss], cloud.valid[::ss], prop)
    else:
        raise ValueError(f"unknown particle scorer {pcfg.scorer!r}")

    # 3. top-k refine: k survivors x R local perturbations
    k = pcfg.top_k
    r = pcfg.refine_candidates
    neg, top_idx = jax.lax.top_k(-eff, k)
    survivors = prop[top_idx]                                   # [k, 3]
    if pcfg.scorer == "grid":
        # the grid's sub-pixel argmin joins the refine pool (slot k-1 = the
        # weakest survivor); its exact score is recomputed with the others
        survivors = survivors.at[k - 1].set(grid_pose)
    loc_xy = jax.random.normal(k_ref, (k, r, 2)) * (ccfg.sigma_xy * 0.3)
    loc_th = jax.random.normal(jax.random.fold_in(k_ref, 1), (k, r, 1)) \
        * (ccfg.sigma_theta * 0.3)
    local = jnp.concatenate([loc_xy, loc_th], axis=-1)
    local = local.at[:, 0].set(0.0)                             # keep original
    refine_poses = (survivors[:, None, :] + local).reshape(k * r, 3)
    rs = max(1, pcfg.refine_subsample)
    ref_eff = _score(state, ccfg, cloud.points[::rs], cloud.valid[::rs],
                     refine_poses).reshape(k, r)
    best_r = jnp.argmin(ref_eff, axis=1)
    refined = refine_poses.reshape(k, r, 3)[jnp.arange(k), best_r]  # [k, 3]
    refined_eff = ref_eff[jnp.arange(k), best_r]

    # 4. estimate = best refined survivor
    b = jnp.argmin(refined_eff)
    best_pose = refined[b]
    best_pose = best_pose.at[2].set(normalize_angle(best_pose[2]))
    best_sum = refined_eff[b]

    # write refined survivors back into the population.  When the refine
    # stage scored on a different beam subset than the population, its sums
    # live on a different scale — rescale by the valid-beam ratio so the
    # resampling weights below stay comparable (strides equal: exact
    # passthrough, bit-identical to the base semantics).
    particles = prop.at[top_idx].set(refined)
    pop_full_beams = pcfg.scorer != "exact"
    if (rs != 1) if pop_full_beams else (ss != rs):
        nb_pop = jnp.maximum(
            jnp.sum(cloud.valid if pop_full_beams else cloud.valid[::ss]), 1)
        nb_ref = jnp.maximum(jnp.sum(cloud.valid[::rs]), 1)
        ratio = nb_pop.astype(jnp.float32) / nb_ref.astype(jnp.float32)
        scaled = jnp.round(refined_eff.astype(jnp.float32) * ratio)
        scaled = jnp.minimum(scaled, jnp.float32(score.INT32_MAX)) \
            .astype(jnp.int32)
        eff = eff.at[top_idx].set(jnp.where(refined_eff == score.INT32_MAX,
                                            score.INT32_MAX, scaled))
    else:
        eff = eff.at[top_idx].set(refined_eff)

    # 5. resample when the effective sample size collapses
    valid_n = jnp.maximum(jnp.sum(cloud.valid), 1)
    # temperature ~ score scale: one map-value unit averaged over the cloud
    t = 2000.0 * valid_n.astype(jnp.float32)
    logw = -eff.astype(jnp.float32) / t
    w = jax.nn.softmax(logw)
    ess = 1.0 / jnp.sum(w * w)
    do_resample = ess < pcfg.resample_ess_frac * p

    u = (jax.random.uniform(k_res) + jnp.arange(p)) / p         # systematic
    cdf = jnp.cumsum(w)
    idx = jnp.searchsorted(cdf, u)
    idx = jnp.clip(idx, 0, p - 1)
    particles = jnp.where(do_resample, particles[idx], particles)
    eff = jnp.where(do_resample, eff[idx], eff)

    # 6. map updates at the estimate (during warmup, trust odometry — the
    #    coreslam PositionSearchBeginning contract)
    warm = state.scan_count >= ccfg.position_search_beginning
    est = jnp.where(warm, best_pose, odo)
    # during warmup the population tracks the odometry estimate directly, so the
    # (meaningless) first odometry delta cannot seed a runaway population
    particles = jnp.where(warm, particles,
                          jnp.broadcast_to(est, particles.shape))
    if ccfg.dense_hole_fill:
        hole = holemap.update_hole_map_dense(
            state.hole_map, ccfg.hole_map_size, ccfg.hole_scale, cloud.points,
            cloud.valid, est, ccfg.hole_width, ccfg.quality, ccfg.angle_bins)
    else:
        hole = holemap.update_hole_map(
            state.hole_map, ccfg.hole_map_size, ccfg.hole_scale, cloud.points,
            cloud.valid, est, ccfg.hole_width, ccfg.quality)
    if ccfg.dense_obstacle_fill:
        obst = obstacle.update_obstacle_map_dense(
            state.obstacle_map, ccfg.obstacle_map_size, ccfg.obstacle_scale,
            cloud.points, cloud.valid, est, ccfg.max_obstacle_hits,
            ccfg.angle_bins)
    else:
        obst = obstacle.update_obstacle_map(
            state.obstacle_map, ccfg.obstacle_map_size, ccfg.obstacle_scale,
            cloud.points, cloud.valid, est, ccfg.max_obstacle_hits)

    new_state = ParticleState(
        particles=particles, scores=eff, hole_map=hole, obstacle_map=obst,
        pose=est, last_odometry=odo,
        scan_count=jnp.where(warm, state.scan_count, state.scan_count + 1),
        key=key)
    return new_state, ParticleInfo(best_sum=best_sum, ess=ess,
                                   resampled=do_resample)
