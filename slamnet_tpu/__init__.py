"""slamnet_tpu — a 2D lidar SLAM framework for the GPU (JAX / XLA / Pallas).

Brand-new implementation of the capabilities of mikkleini/slam.net (C#):

- ``models.coreslam``  — CoreSLAM: fixed-iteration Monte-Carlo pose search scored
  against a blurred "hole map", plus hole-map / obstacle-map ray updates
  (reference: /root/reference/CoreSLAM/CoreSLAMProcessor.cs).
- ``models.hector``    — HectorSLAM: Gauss-Newton scan-to-map matching with bilinear
  log-odds gradient interpolation over a multi-resolution occupancy pyramid
  (reference: /root/reference/HectorSLAM/).
- ``models.particle``  — batched many-particle CoreSLAM scoring layer (no reference counterpart).
- ``graph``            — keyframe pose-graph with loop closures, distributed Gauss-Newton
  (greenfield; no counterpart in the reference).
- ``parallel``         — device-mesh sharding: candidate-batch data parallelism,
  beam-axis (sequence) parallelism with psum'd Hessians, map-tile sharding with
  halo exchange.
- ``sim``              — headless JAX port of the reference's Box2D-simulated field;
  the test oracle (reference: /root/reference/Simulation/).

Design stance: functional core ``(state, scan, key) -> (state', info)`` where state is
a pytree of map arrays + pose + counters.  All reference hot loops become fused jitted
kernels; the reference's thread pools (BaseSLAM/ParallelWorker.cs) dissolve into
vmap/pjit SPMD.
"""

__version__ = "0.1.0"
