"""Worker process for the true multi-process jax.distributed test.

Spawned by tests/test_multiprocess.py (2 OS processes, CPU backend, 4 virtual
devices each).  Each process:
  1. brings up the cluster via parallel.initialize_multihost (the multi-host
     entry point — jax.distributed.initialize under the hood);
  2. builds a ('tile' x 'search') mesh over all 8 GLOBAL devices, laid out so
     the 'search' (beam) axis SPANS the two processes — each process then
     feeds only ITS half of every scan's beam axis through
     parallel.host_local_scans_to_global (per-host scan ingestion,
     SURVEY.md §5.8 P6);
  3. runs hector_sharded steps (row-tiled pyramid + beam-sharded (H,dTr)
     psums + halo ppermutes — now crossing the process boundary over Gloo)
     and checks the result against the dense single-process pipeline run
     locally on the same scans.

Not a pytest module (leading underscore): run as
  python tests/_multiproc_worker.py <pid> <nproc> <port>
Prints "WORKER_OK <pid>" on success.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402


def main(pid: int, nproc: int, port: int) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from slamnet_tpu.parallel import (host_local_scans_to_global,
                                      initialize_multihost)

    initialize_multihost(f"localhost:{port}", nproc, pid)
    assert jax.device_count() == 8, jax.device_count()
    assert jax.local_device_count() == 4
    assert jax.process_count() == nproc

    from slamnet_tpu.core import HectorConfig, SimConfig
    from slamnet_tpu.core.scan import Scan
    from slamnet_tpu.models import hector, hector_sharded
    from slamnet_tpu.sim import default_field, lidar

    # 'search' spans BOTH processes: device[t, s] = devices[s*2 + t], so
    # search shards 0-1 live on process 0 and 2-3 on process 1 — beam-axis
    # psums and scan feeding genuinely cross the process boundary.
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2).T, ("tile", "search"))

    # Small full-field config: 128 px at 0.3125 m/px covers the 40 m field
    # with zero map offset (offset handling matches the reference: zero).
    cfg = HectorConfig(map_resolution=40.0 / 128, map_size=128, num_levels=2,
                       estimate_iterations=(3, 2))
    sim = SimConfig()
    nb = 256  # _beam_pad(256, 4) == 256: beam axis shards evenly

    # identical deterministic scan log on every process (same PRNG key)
    fld = default_field()
    angles = jnp.asarray(lidar.revolution_angles(nb))
    traj = np.stack([np.array([20.0 + 0.05 * t, 20.0, 0.0], np.float32)
                     for t in range(6)])

    @jax.jit
    def gen(poses, key):
        keys = jax.random.split(key, poses.shape[0])

        def one(p, k):
            return lidar.scan_revolution(fld, p, angles, sim.max_scan_dist,
                                         sim.measure_error, k)
        return jax.vmap(one)(poses, keys)

    radii, valids = jax.device_get(gen(jnp.asarray(traj),
                                       jax.random.PRNGKey(9)))
    pts = np.stack([radii * np.cos(np.asarray(angles))[None],
                    radii * np.sin(np.asarray(angles))[None]], -1)

    # ---- dense single-process reference, same scans ------------------------
    dstate = hector.init(cfg, traj[0])
    dense_poses = []
    for t in range(traj.shape[0]):
        force = t < 4
        hint = traj[t] if force else dstate.match_pose
        dstate, _ = hector.update(
            dstate, Scan(jnp.asarray(pts[t]), jnp.asarray(valids[t]),
                         jnp.zeros(3, jnp.float32)),
            jnp.asarray(hint, jnp.float32), cfg,
            map_without_matching=jnp.asarray(force))
        dense_poses.append(np.asarray(dstate.match_pose))

    # ---- sharded multi-process run -----------------------------------------
    state = hector_sharded.init(mesh, cfg, traj[0])
    step = hector_sharded.make_step(mesh, cfg, nb)

    n_search = mesh.shape["search"]
    half = nb // nproc  # this process's beam rows (search spans processes)

    def feed(arr):
        """Per-process scan feeding: each process contributes only ITS beam
        rows of the global ('search'-sharded) scan arrays."""
        local = arr[pid * half:(pid + 1) * half]
        return host_local_scans_to_global(mesh, local, "search")

    for t in range(traj.shape[0]):
        force = t < 4
        if force:
            state = state._replace(
                match_pose=jax.device_put(jnp.asarray(traj[t], jnp.float32),
                                          jax.sharding.NamedSharding(
                                              mesh, jax.sharding.PartitionSpec())))
        state, info = step(state, feed(pts[t]), feed(valids[t]),
                           jnp.asarray(force))
        pose = np.asarray(jax.device_get(state.match_pose))
        assert np.isfinite(pose).all(), pose
        if not force:
            # matcher float-sum order differs across shardings; poses agree
            # to float tolerance (same contract as tests/test_hector_sharded)
            assert np.allclose(pose, dense_poses[t], atol=1e-4), (
                t, pose, dense_poses[t])

    # ---- map equality on this process's OWN shards -------------------------
    # After the forced (bootstrap) phase both pipelines applied line-mode
    # updates at identical poses; the final matched steps only move the pose.
    # Line-mode occupancy updates are bitwise-equal under sharding (masks are
    # unions over beams), so each owned tile must match the dense pyramid.
    expected = hector_sharded.shard_tiles_host(np.asarray(dstate.maps), cfg,
                                               mesh.shape["tile"])
    for shard in state.local_maps.addressable_shards:
        t_idx = shard.index[0].start or 0
        got = np.asarray(shard.data).reshape(-1)
        want = expected[t_idx].reshape(-1)
        assert got.shape == want.shape, (got.shape, want.shape)
        np.testing.assert_allclose(got, want, atol=1e-5)

    print(f"WORKER_OK {pid}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
