"""Device-mesh construction helpers.

The reference's entire "distributed backend" is a hand-rolled thread pool
(BaseSLAM/ParallelWorker.cs); here it is a jax.sharding.Mesh with named axes
and XLA collectives between devices (SURVEY.md §2.5, §5.8).  The mesh shape
follows the algorithm alone: every device reaches every other at one rate.

Axis conventions used across the framework:
  'search' — data parallelism over Monte-Carlo candidates / particles (P2)
  'beam'   — sequence parallelism over the lidar beam axis (P3)
  'tile'   — map-row tiling: grid memory sharded across devices with 1-row
             halo exchange (the long-context story, SURVEY.md §5.7)
"""
from __future__ import annotations

from typing import Mapping, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axes: Mapping[str, int], devices: Sequence | None = None) -> Mesh:
    """Create a Mesh with the given {axis_name: size} layout.

    The product of sizes must equal the device count (defaults to all devices).
    """
    names = tuple(axes.keys())
    shape = tuple(axes.values())
    if devices is None:
        devices = jax.devices()[:int(np.prod(shape))]
    return Mesh(np.asarray(devices).reshape(shape), names)


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Multi-host bring-up: jax.distributed.initialize with env fallbacks.

    Each host calls this before any jax op; afterwards jax.devices() spans
    every process and make_mesh() lays axes over all of them.  Pass all
    three arguments where nothing tells JAX of the cluster (a plain GPU
    host: coordinator_address="localhost:<port>").
    Single-host CI exercises the same mesh code via
    xla_force_host_platform_device_count (tests/conftest.py).
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def host_local_scans_to_global(mesh: Mesh, local_batch, axis: str):
    """Per-host scan feeding: assemble a global array whose `axis`
    dimension is sharded across processes from each host's local batch
    (SURVEY.md §5.8 P6 — the scan-ingestion handoff across hosts)."""
    from jax.sharding import PartitionSpec
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, PartitionSpec(axis)), local_batch)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def sharded(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))
