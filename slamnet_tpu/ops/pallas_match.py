"""The coarse-to-fine Gauss-Newton match as ONE Pallas kernel (Triton route).

A match is 7/4/4 (Hector) or 20 (loop-closure frontend) DEPENDENT GN
iterations over at most a few hundred beams: tiny work that XLA splits into
several fusions per iteration.  Here one program runs a whole match:

  * beams are one power-of-two block vector (`block_beams`);
  * the four bilinear neighbours are gather loads straight from the flat f32
    pyramid (the same concatenated table `models/hector` carries; 210,000
    cells at 3x400 px, which stays in L2 across iterations);
  * the 9 Hessian/gradient sums are block reductions and the 3x3 adjugate
    solve runs on scalars in registers (`ops/gn._solve_scalar`, shared with
    the XLA matcher, as are `_gn_coords` and `_gn_rows`);
  * `grid=(B,)`: the fleet runs one program per robot, all in parallel.

Semantics are the `gather` matcher's (`ops/gn.fused_gn_iteration_stats`,
`matcher_mode="gather"`): same f32 table values, same per-beam math; only
the order of the beam sums differs.  Callers keep their own empty-scan
fallback and statistics, exactly as on the gather path.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .gn import _gn_coords, _gn_rows, _solve_scalar

_TWO_PI = 2.0 * jnp.pi


class Level(NamedTuple):
    """One pyramid level as the kernel sees it (all static)."""
    offset: int        # start of the level inside one instance's flat table
    width: int         # level size in pixels (square)
    scale: float       # map pixels per meter
    iterations: int    # GN iterations at this level


def interpret_for(platform: str | None = None) -> bool:
    """Whether Pallas kernels run interpreted on `platform` (default: JAX's
    default backend).  Compiled on "gpu"; interpreted only on "cpu", where
    the tests run; no other platform has a route."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(
        f"the Pallas matcher compiles for 'gpu' and is interpreted on 'cpu'; "
        f"platform {platform!r} has no route")


def block_beams(n: int) -> int:
    """Kernel beam block: the next power of two >= n (Triton block rule)."""
    return max(16, pl.next_power_of_2(n))


def levels_of(cfg) -> Tuple[Level, ...]:
    """A HectorConfig's pyramid as kernel levels, coarsest first."""
    if cfg.early_exit_tol > 0.0:
        raise ValueError("matcher_mode='pallas' runs the fixed per-level "
                         "iteration counts; early_exit_tol is unsupported")
    return tuple(Level(cfg.level_offsets[i], cfg.level_sizes[i],
                       1.0 / cfg.level_resolutions[i],
                       cfg.estimate_iterations[i])
                 for i in range(cfg.num_levels - 1, -1, -1))


def solver_args(cfg) -> dict:
    """A HectorConfig's map origin and GN step guards as `match` kwargs."""
    return dict(origin=cfg.offset, deriv_clamp=cfg.deriv_clamp,
                xy_clamp=cfg.xy_step_clamp_px, damping=cfg.gn_damping)


def _match_kernel(levels, cells, origin, deriv_clamp, xy_clamp, damping,
                  table_ref, x_ref, y_ref, v_ref, pose_ref, out_ref):
    X = x_ref[...]                         # [NB] robot-frame beam x, meters
    Y = y_ref[...]
    valid = v_ref[...] > 0.0
    base = pl.program_id(0) * cells        # this instance's table
    ox, oy = origin
    px, py, th = pose_ref[0], pose_ref[1], pose_ref[2]
    z = jnp.float32(0.0)
    fails, resid, n_in = z, z, z

    for lv in levels:
        def gn_step(_, carry, lv=lv):
            ex, ey, th, fails, _, _ = carry
            sr, cr, mx, my, ok, xi, yi = _gn_coords(
                lv.width, lv.scale, (ex, ey, th), X, Y, valid)
            idx = base + lv.offset + yi * lv.width + xi
            v = (jax.nn.sigmoid(table_ref[idx]),
                 jax.nn.sigmoid(table_ref[idx + 1]),
                 jax.nn.sigmoid(table_ref[idx + lv.width]),
                 jax.nn.sigmoid(table_ref[idx + lv.width + 1]))
            sums = [jnp.sum(r) for r in
                    _gn_rows(v, mx, my, xi, yi, ok, X, Y, sr, cr, True)]
            d0, d1, d2, H00, H01, H02, H11, H12, H22, rs, ni = sums
            s0, s1, s2, solved = _solve_scalar(H00, H01, H02, H11, H12, H22,
                                               d0, d1, d2, deriv_clamp,
                                               xy_clamp, damping)
            return (ex + s0, ey + s1, th + s2,
                    fails + jnp.where(solved, z, 1.0),
                    rs, ni)

        carry = (px * lv.scale + ox, py * lv.scale + oy, th, fails, resid,
                 n_in)
        ex, ey, th, fails, resid, n_in = jax.lax.fori_loop(
            0, lv.iterations, gn_step, carry)
        # heading to (-pi, pi] (core/geometry.normalize_angle), map -> world
        a = jnp.mod(jnp.mod(th, _TWO_PI) + _TWO_PI, _TWO_PI)
        th = jnp.where(a > jnp.pi, a - _TWO_PI, a)
        px = (ex - ox) / lv.scale
        py = (ey - oy) / lv.scale

    lane = jax.lax.broadcasted_iota(jnp.int32, (8,), 0)
    out_ref[...] = jnp.where(
        lane == 0, px, jnp.where(
            lane == 1, py, jnp.where(
                lane == 2, th, jnp.where(
                    lane == 3, fails, jnp.where(
                        lane == 4, resid, jnp.where(lane == 5, n_in, z))))))


def match(table: jnp.ndarray, levels: Tuple[Level, ...], X: jnp.ndarray,
          Y: jnp.ndarray, valid: jnp.ndarray, hints: jnp.ndarray, *,
          origin=(0.0, 0.0), deriv_clamp: float = 0.2,
          xy_clamp: float = 0.0, damping: float = 0.0):
    """Run B coarse-to-fine matches, one kernel program each.

    table f32[B*cells]: every instance's flat pyramid, back to back;
    X, Y f32[B, N] robot-frame beam coordinates (meters), valid bool[B, N];
    hints f32[B, 3] world poses; levels coarsest first; origin = the map
    offset in pixels (HectorConfig.offset).

    Returns (poses f32[B, 3] world, with heading in (-pi, pi];
    solve_failures i32[B]; resid_sum f32[B] and n_in f32[B] of the last
    iteration) — the gather matcher's outputs before its empty-scan
    fallback."""
    b, n = X.shape
    cells = table.shape[0] // b
    assert table.shape[0] == b * cells < 2 ** 31, (table.shape, b)  # i32 idx
    nb = block_beams(n)
    pad = ((0, 0), (0, nb - n))
    X = jnp.pad(X.astype(jnp.float32), pad)
    Y = jnp.pad(Y.astype(jnp.float32), pad)
    V = jnp.pad(valid.astype(jnp.float32), pad)
    kernel = functools.partial(
        _match_kernel, tuple(levels), cells,
        (float(origin[0]), float(origin[1])), float(deriv_clamp),
        float(xy_clamp), float(damping))
    beams = pl.BlockSpec((None, nb), lambda i: (i, 0))
    out = pl.pallas_call(
        kernel,
        grid=(b,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY), beams, beams, beams,
                  pl.BlockSpec((None, 3), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((None, 8), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((b, 8), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=min(4, max(1, nb // 128)), num_stages=1),
        interpret=interpret_for(),
        name="gn_match",
    )(table, X, Y, V, hints.astype(jnp.float32))
    return (out[:, :3], out[:, 3].astype(jnp.int32), out[:, 4], out[:, 5])
