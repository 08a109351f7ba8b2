#!/usr/bin/env python
"""Graph-SLAM bench in isolation (the bench.py graph section): keyframes +
loop closures + pose-graph optimization over a 512-scan revisit trajectory.
Run on the GPU: python scripts/bench_graph.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import bench
from slamnet_tpu.sim import lidar


def main():
    angles = jnp.asarray(lidar.revolution_angles(400))
    print(f"device: {jax.devices()[0]}")
    print(json.dumps(bench.bench_graph(angles)))


if __name__ == "__main__":
    main()
