#!/usr/bin/env python
"""Phase breakdown of the headline Hector bench: where does the ms/scan go?

Measures, each as best-of-5 on-device lax.scan replays over the same scan log:
  A. match-only (no map update at all)
  B. full update with the motion gate (the bench configuration)
  C. update_maps EVERY scan (upper bound on the scatter cost)
  D. full update, gate forced off via impossible thresholds
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp

from slamnet_tpu.core import HectorConfig, SimConfig
from slamnet_tpu.core.scan import Scan
from slamnet_tpu.models import hector
from slamnet_tpu.sim import default_field, lidar
from slamnet_tpu.sim.trajectory import loop_trajectory

cfg = HectorConfig(num_levels=3, estimate_iterations=(7, 4, 4))
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
            return lidar.scan_revolution(fld_c, p, angles_c, sim.max_scan_dist,
                                         sim.measure_error, k)
        return jax.vmap(one)(poses, keys)

    radii_c, valids_c = genlog(jax.device_put(jnp.asarray(traj), cpu),
                               jax.device_put(jax.random.PRNGKey(0), cpu))

dev = jax.devices()[0]
radii = jax.device_put(np.asarray(radii_c), dev)
valids = jax.device_put(np.asarray(valids_c), dev)
angles = jax.device_put(jnp.asarray(angles_np), dev)
traj_d = jax.device_put(jnp.asarray(traj), dev)


def make_cloud(r, v):
    pts = jnp.stack([r * jnp.cos(angles), r * jnp.sin(angles)], -1)
    return Scan(pts, v, jnp.zeros(3, jnp.float32))


@jax.jit
def boot(state, radii, valids, poses):
    def body(st, inp):
        r, v, p = inp
        st, _ = hector.update(st, make_cloud(r, v), p, cfg,
                              map_without_matching=jnp.asarray(True))
        return st, None
    st, _ = jax.lax.scan(body, state, (radii, valids, poses))
    return st


state = hector.init(cfg, traj[0])
state = boot(state, radii[:bootstrap], valids[:bootstrap], traj_d[:bootstrap])
jax.block_until_ready(state)


def timed(name, fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(5):
        t0 = time.time()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.time() - t0)
    print(f"{name}: {best*1e3:.2f} ms total, {best/n_scans*1e6:.1f} us/scan,"
          f" {n_scans/best:.0f} scans/s", flush=True)
    return out


# A. match-only
@jax.jit
def replay_match(state, radii, valids):
    def body(st, inp):
        r, v = inp
        mp = hector.match(st.maps, make_cloud(r, v), st.match_pose, cfg)
        return st._replace(match_pose=mp), mp
    return jax.lax.scan(body, state, (radii, valids))

timed("A match-only (fixed iters)", replay_match, state,
      radii[bootstrap:], valids[bootstrap:])

cfg_ee = dataclasses.replace(cfg, early_exit_tol=1e-3)

@jax.jit
def replay_match_ee(state, radii, valids):
    def body(st, inp):
        r, v = inp
        mp = hector.match(st.maps, make_cloud(r, v), st.match_pose, cfg_ee)
        return st._replace(match_pose=mp), mp
    return jax.lax.scan(body, state, (radii, valids))

timed("A2 match-only (early-exit)", replay_match_ee, state,
      radii[bootstrap:], valids[bootstrap:])


def make_replay(cfg_x):
    @jax.jit
    def replay(state, radii, valids):
        def body(st, inp):
            r, v = inp
            st, info = hector.update(st, make_cloud(r, v), st.match_pose, cfg_x,
                                     map_without_matching=jnp.asarray(False))
            return st, (st.match_pose, info.map_updated)
        return jax.lax.scan(body, state, (radii, valids))
    return replay

# B. bench config (gated)
_, (p, upd) = timed("B gated full (fixed iters)", make_replay(cfg),
                    state, radii[bootstrap:], valids[bootstrap:])
print("   map updates fired:", int(np.asarray(upd).sum()), flush=True)

_, (p, upd) = timed("B2 gated full (early-exit)", make_replay(cfg_ee),
                    state, radii[bootstrap:], valids[bootstrap:])

# D. gate never fires (thresholds huge)
cfg_never = dataclasses.replace(cfg, min_distance_diff_for_map_update=1e9,
                                min_angle_diff_for_map_update=1e9)
timed("D gated-never full", make_replay(cfg_never),
      state, radii[bootstrap:], valids[bootstrap:])

# C. update every scan
cfg_always = dataclasses.replace(cfg, min_distance_diff_for_map_update=-1.0)
timed("C update-every-scan", make_replay(cfg_always),
      state, radii[bootstrap:], valids[bootstrap:])

# E. single ungated update_maps cost
@jax.jit
def one_update(maps, r, v, pose):
    return hector.update_maps(maps, make_cloud(r, v), pose, cfg)

m = one_update(state.maps, radii[bootstrap], valids[bootstrap],
               traj_d[bootstrap])
jax.block_until_ready(m)
best = float("inf")
for _ in range(20):
    t0 = time.time()
    m = one_update(state.maps, radii[bootstrap], valids[bootstrap],
                   traj_d[bootstrap])
    jax.block_until_ready(m)
    best = min(best, time.time() - t0)
print(f"E one update_maps call: {best*1e6:.0f} us (incl host dispatch)",
      flush=True)
