#!/usr/bin/env python
"""Correlative-search restructuring experiments.

The search was most of CoreSLAM's per-scan cost on the first accelerator and
all of the particle grid scorer; its dominant operand is the per-scan rebuild of W*W
shifted hole-map copies x 3 planes (hi/lo/mask) = ~54 MB/scan.  Variants:

  base     ops/correlate.correlative_scores as shipped (hi/lo/mask planes)
  sep_nb   the in-bounds count nb is SEPARABLE per point (a box condition in
           y and x independently): nb = einsum over tiny [K,N,W] row/col
           masks — the mask third of the big operand vanishes, bit-exact
  conv     sep_nb + the score sums as ONE lax.conv cross-correlation of the
           padded hi/lo planes (batch=2) with the K count grids as filters —
           XLA materializes whatever im2col it wants internally; no manual
           shifted-plane build at all
  conv_hp  conv with precision=HIGHEST (exactness guard if default rounds)

Each variant is checked for BIT-EQUALITY against base on a real scan before
timing; timing = full CoreSLAM production pipeline replay (512 scans,
on-device lax.scan), same process, back to back.

Usage: python scripts/bench_correlate_variants.py [--scans 512]
"""
import argparse
import dataclasses
import sys
import time

sys.path.insert(0, ".")


def make_variants():
    import jax

    from slamnet_tpu.runtime import setup_compile_cache
    setup_compile_cache()
    import jax.numpy as jnp
    from slamnet_tpu.core.geometry import csharp_trunc
    from slamnet_tpu.ops import correlate

    def _snap_counts(hole_map_flat, size, scale, points, valid, search_pose,
                     thetas, window):
        """Shared prolog: snapped coords + one-hot count grids (as base)."""
        K = thetas.shape[0]
        R = window // 2
        spad = size + 2 * R
        px = search_pose[0] * scale + 0.5
        py = search_pose[1] * scale + 0.5
        c = (jnp.cos(thetas) * scale)[:, None]
        s = (jnp.sin(thetas) * scale)[:, None]
        X = points[:, 0][None, :]
        Y = points[:, 1][None, :]
        xb = csharp_trunc(px + c * X - s * Y)
        yb = csharp_trunc(py + s * X + c * Y)
        ok = (valid[None, :] & (xb >= -R) & (xb < size + R)
              & (yb >= -R) & (yb < size + R))
        grid_ids = jnp.arange(spad, dtype=xb.dtype)
        oh_y = ((yb + R)[:, :, None] == grid_ids).astype(jnp.float32) \
            * ok[:, :, None].astype(jnp.float32)
        oh_x = ((xb + R)[:, :, None] == grid_ids).astype(jnp.float32)
        cnt = jnp.einsum("kns,knt->kst", oh_y, oh_x,
                         preferred_element_type=jnp.float32)
        return xb, yb, ok, cnt, spad, R

    def _sep_nb(xb, yb, ok, size, window):
        """nb[k,dy,dx] exactly, from separable per-point box masks."""
        R = window // 2
        dshift = jnp.arange(window, dtype=xb.dtype) - R
        rowok = (ok[:, :, None] & ((yb[:, :, None] + dshift) >= 0)
                 & ((yb[:, :, None] + dshift) < size)).astype(jnp.float32)
        colok = (((xb[:, :, None] + dshift) >= 0)
                 & ((xb[:, :, None] + dshift) < size)).astype(jnp.float32)
        return jnp.einsum("knw,knv->kwv", rowok, colok,
                          preferred_element_type=jnp.float32).astype(jnp.int32)

    def sep_nb_scores(hole_map_flat, size, scale, points, valid, search_pose,
                      thetas, window):
        K = thetas.shape[0]
        xb, yb, ok, cnt, spad, R = _snap_counts(
            hole_map_flat, size, scale, points, valid, search_pose, thetas,
            window)
        nb = _sep_nb(xb, yb, ok, size, window)
        # hi/lo shifted planes only (mask planes gone)
        q = jnp.zeros((size + 4 * R, size + 4 * R), jnp.int32)
        q = jax.lax.dynamic_update_slice(q, hole_map_flat.reshape(size, size),
                                         (2 * R, 2 * R))
        shifts = []
        for dy in range(window):
            for dx in range(window):
                shifts.append(jax.lax.dynamic_slice(
                    q, (dy, dx), (spad, spad)).reshape(-1))
        hs = jnp.stack(shifts)
        w2 = window * window
        big = jnp.concatenate([(hs >> 8).astype(jnp.float32),
                               (hs & 0xFF).astype(jnp.float32)], axis=0)
        out = jnp.dot(cnt.reshape(K, spad * spad), big.T,
                      preferred_element_type=jnp.float32)
        sums = (256.0 * out[:, :w2] + out[:, w2:]).astype(jnp.int32)
        return sums.reshape(K, window, window), nb

    def make_conv_scores(precision):
        def conv_scores(hole_map_flat, size, scale, points, valid,
                        search_pose, thetas, window):
            K = thetas.shape[0]
            xb, yb, ok, cnt, spad, R = _snap_counts(
                hole_map_flat, size, scale, points, valid, search_pose,
                thetas, window)
            nb = _sep_nb(xb, yb, ok, size, window)
            P = size + 4 * R
            q = jnp.zeros((P, P), jnp.int32)
            q = jax.lax.dynamic_update_slice(
                q, hole_map_flat.reshape(size, size), (2 * R, 2 * R))
            lhs = jnp.stack([(q >> 8).astype(jnp.float32),
                             (q & 0xFF).astype(jnp.float32)]
                            )[:, None]                      # [2, 1, P, P]
            rhs = cnt[:, None]                              # [K, 1, spad, spad]
            out = jax.lax.conv_general_dilated(
                lhs, rhs, window_strides=(1, 1), padding="VALID",
                dimension_numbers=("NCHW", "OIHW", "NCHW"),
                precision=precision)                        # [2, K, 2R+1, 2R+1]
            sums = (256.0 * out[0, :, :window, :window]
                    + out[1, :, :window, :window]).astype(jnp.int32)
            return sums, nb
        return conv_scores

    return {
        "base": correlate.correlative_scores,
        "sep_nb": sep_nb_scores,
        "conv": make_conv_scores(None),
        "conv_hp": make_conv_scores(jax.lax.Precision.HIGHEST),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=512)
    ap.add_argument("--search-only", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from slamnet_tpu.core import CoreSlamConfig, SimConfig
    from slamnet_tpu.core.scan import Scan
    from slamnet_tpu.models import coreslam
    from slamnet_tpu.ops import correlate
    from slamnet_tpu.sim import default_field, lidar
    from slamnet_tpu.sim.trajectory import loop_trajectory

    sim = SimConfig()
    n_total = args.scans + 10
    cpu = jax.devices("cpu")[0]
    fld = default_field()
    angles_np = lidar.revolution_angles(sim.num_scan_points)
    traj = loop_trajectory(speed=0.3)[:n_total]
    with jax.default_device(cpu):
        fld_c = jax.tree.map(lambda x: jax.device_put(x, cpu), fld)
        angles_c = jax.device_put(jnp.asarray(angles_np), cpu)

        @jax.jit
        def genlog(poses, key):
            keys = jax.random.split(key, poses.shape[0])

            def one(p, k):
                return lidar.scan_revolution(fld_c, p, angles_c,
                                             sim.max_scan_dist,
                                             sim.measure_error, k)
            return jax.vmap(one)(poses, keys)

        radii_c, valids_c = genlog(
            jax.device_put(jnp.asarray(traj), cpu),
            jax.device_put(jax.random.PRNGKey(0), cpu))

    dev = jax.devices()[0]
    radii = jax.device_put(np.asarray(radii_c), dev)
    valids = jax.device_put(np.asarray(valids_c), dev)
    angles = jax.device_put(jnp.asarray(angles_np), dev)

    variants = make_variants()
    cfg = dataclasses.replace(CoreSlamConfig(), search_mode="correlative",
                              dense_hole_fill=True, dense_obstacle_fill=True)

    # ---- bit-equality check on a real mid-replay state ----------------------
    state = coreslam.init(cfg, traj[0], key=jax.random.PRNGKey(1))
    pts0 = jnp.stack([radii[0] * jnp.cos(angles),
                      radii[0] * jnp.sin(angles)], -1)
    for t in range(8):
        pts_t = jnp.stack([radii[t] * jnp.cos(angles),
                           radii[t] * jnp.sin(angles)], -1)
        state, _ = jax.jit(coreslam.update_cloud, static_argnums=3)(
            state, Scan(pts_t, valids[t], jnp.zeros(3, jnp.float32)),
            state.pose, cfg)
    size = cfg.hole_map_size
    scale = cfg.hole_scale
    span = cfg.corr_theta_span or 3.0 * cfg.sigma_theta
    thetas = state.pose[2] + jnp.linspace(-span, span, cfg.corr_num_theta)
    argsx = (state.hole_map, size, scale, pts0, valids[0], state.pose,
             thetas, cfg.corr_window)
    s0, n0 = jax.jit(variants["base"], static_argnums=(1, 7))(*argsx)
    for name, fn in variants.items():
        if name == "base":
            continue
        s1, n1 = jax.jit(fn, static_argnums=(1, 7))(*argsx)
        ds = int(jnp.abs(s0 - s1).max())
        dn = int(jnp.abs(n0 - n1).max())
        print(f"equality {name:8s}: max|dsums|={ds}  max|dnb|={dn}",
              flush=True)

    # ---- full-pipeline timing ----------------------------------------------
    orig = correlate.correlative_scores
    for name, fn in variants.items():
        correlate.correlative_scores = fn

        @jax.jit
        def replay(state, radii, valids):
            def body(st, inp):
                rr, vv = inp
                pts = jnp.stack([rr * jnp.cos(angles),
                                 rr * jnp.sin(angles)], -1)
                st, _ = coreslam.update_cloud(
                    st, Scan(pts, vv, jnp.zeros(3, jnp.float32)), st.pose,
                    cfg)
                return st, st.pose
            return jax.lax.scan(body, state, (radii, valids))

        st0 = coreslam.init(cfg, traj[0], key=jax.random.PRNGKey(1))
        stf, poses = replay(st0, radii, valids)
        jax.block_until_ready(stf)
        best = 1e9
        for _ in range(3):
            t0 = time.time()
            stf, poses = replay(st0, radii, valids)
            jax.block_until_ready(stf)
            best = min(best, time.time() - t0)
        err = np.asarray(poses) - traj
        pe = np.linalg.norm(err[:, :2], axis=1)
        print(f"{name:8s} {n_total / best:8.1f} scans/s   "
              f"ate {np.sqrt((pe ** 2).mean()):.4f}  max {pe.max():.3f}",
              flush=True)
        correlate.correlative_scores = orig


if __name__ == "__main__":
    main()
