#!/usr/bin/env python
"""Bisect _match_batch's cost per batch-scan: iterations vs levels vs fixed
per-scan overhead.  Times T-scan matcher-only replays at B=64 for several
(num_levels, estimate_iterations) combinations.
"""
import dataclasses
import sys
import time

sys.path.insert(0, ".")


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slamnet_tpu.core import HectorConfig
    from slamnet_tpu.models import fleet

    B, T, N = 64, 64, 512
    rng = np.random.default_rng(0)
    poses0 = np.tile(np.asarray([20.0, 20.0, 0.0], np.float32), (B, 1))
    radii = jnp.asarray(rng.uniform(2.0, 20.0, (T, B, N)), jnp.float32)
    valids = jnp.ones((T, B, N), bool)
    angles = jnp.asarray(np.linspace(0, 2 * np.pi, N, endpoint=False),
                         jnp.float32)

    def run(name, cfg):
        states = fleet.init_fleet(cfg, poses0)

        @jax.jit
        def match_only(states, radii, valids):
            def body(sts, inp):
                r, v = inp
                pts = jnp.stack([r * jnp.cos(angles)[None, :],
                                 r * jnp.sin(angles)[None, :]], -1)
                matched, _ = fleet._match_batch(sts.maps,
                                                fleet.fleet_cells(cfg),
                                                pts, v, sts.match_pose, cfg)
                sts = sts._replace(match_pose=matched)
                return sts, matched
            return jax.lax.scan(body, states, (radii, valids))

        out = match_only(states, radii, valids)
        jax.block_until_ready(out)
        best = 1e9
        for _ in range(3):
            t0 = time.time()
            out = match_only(states, radii, valids)
            jax.block_until_ready(out)
            best = min(best, time.time() - t0)
        print(f"{name:44s} {best / T * 1e3:8.2f} ms/batch-scan")

    base = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4),
                        xy_step_clamp_px=10.0, match_subsample=4)
    print(f"device: {jax.devices()[0]}  B={B} T={T}")
    run("3 levels, (7,4,4) [baseline]", base)
    run("3 levels, (1,1,1)", dataclasses.replace(
        base, estimate_iterations=(1, 1, 1)))
    run("1 level, (7,)", HectorConfig(
        num_levels=1, estimate_iterations=(7,), xy_step_clamp_px=10.0,
        match_subsample=4))
    run("1 level, (1,)", HectorConfig(
        num_levels=1, estimate_iterations=(1,), xy_step_clamp_px=10.0,
        match_subsample=4))
    run("3 levels, (7,4,4), subsample=1", dataclasses.replace(
        base, match_subsample=1))


if __name__ == "__main__":
    main()
