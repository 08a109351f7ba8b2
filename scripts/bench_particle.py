#!/usr/bin/env python
"""Particle-layer bench modes in isolation (the bench.py particle section,
runnable without the full bench): exact / grid / grid_dense scoring over the
512-scan full-field replay — pass --all for the full 5-mode table
(+ sub4, grid_small).  Run on the GPU: python scripts/bench_particle.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import bench
from slamnet_tpu.core import SimConfig
from slamnet_tpu.sim import default_field, lidar
from slamnet_tpu.sim.trajectory import loop_trajectory


def main():
    sim = SimConfig()
    n_scans = 512
    bootstrap = 10
    cpu = jax.devices("cpu")[0]
    fld = default_field()
    angles_np = lidar.revolution_angles(sim.num_scan_points)
    traj = loop_trajectory(speed=0.3)[: n_scans + bootstrap]

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

        radii_c, valids_c = genlog(jax.device_put(jnp.asarray(traj), cpu),
                                   jax.device_put(jax.random.PRNGKey(0), cpu))

    dev = jax.devices()[0]
    radii = jax.device_put(np.asarray(radii_c), dev)
    valids = jax.device_put(np.asarray(valids_c), dev)
    angles = jax.device_put(jnp.asarray(angles_np), dev)

    print(f"device: {dev}")
    out = bench.bench_particle(radii, valids, angles, traj, n_scans, bootstrap,
                               all_modes="--all" in sys.argv)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
