"""Scan containers as fixed-shape arrays (static shapes, validity masks).

The reference represents a lidar revolution as ``List<ScanSegment>`` of ``Ray``
objects with misses simply absent (BaseSLAM/ScanSegment.cs, Ray.cs;
MainWindow.xaml.cs:395-400 drops missed rays).  Variable-length lists are hostile to
XLA, so here a scan is always a fixed-width array plus a validity mask:

- ``Scan``      — cartesian cloud: points f32[N,2] in robot-local meters + valid mask
                  (the analogue of BaseSLAM/ScanCloud.cs).
- ``SegmentScan`` — polar rays grouped into segments, each with its own capture pose,
                  for scans taken while moving (the analogue of ScanSegment lists).

``segments_to_cloud`` reproduces CoreSLAMProcessor.ScanSegmentsToCloud
(CoreSLAMProcessor.cs:187-207): each segment's pose is taken relative to the newest
odometry pose, de-skewing the revolution.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from . import geometry


class Scan(NamedTuple):
    """A cartesian scan cloud with fixed width N.

    points: f32[N, 2] robot-local meters; valid: bool[N]; pose: f32[3] — the pose the
    cloud is expressed relative to (ScanCloud.Pose; zero in the simulator).
    """

    points: jnp.ndarray
    valid: jnp.ndarray
    pose: jnp.ndarray

    @property
    def n(self) -> int:
        return self.points.shape[-2]

    @staticmethod
    def from_points(points, valid=None, pose=None) -> "Scan":
        points = jnp.asarray(points, jnp.float32)
        if valid is None:
            valid = jnp.ones(points.shape[:-1], dtype=bool)
        if pose is None:
            pose = jnp.zeros(points.shape[:-2] + (3,), jnp.float32)
        return Scan(points, jnp.asarray(valid), jnp.asarray(pose, jnp.float32))


class SegmentScan(NamedTuple):
    """Polar rays grouped into S segments of up to N rays each.

    angles/radii: f32[S, N] (angle in the robot frame, radius meters);
    valid: bool[S, N]; poses: f32[S, 3] — odometry pose at each segment's capture.
    The last segment's pose is "the newest odometry pose" (CoreSLAMProcessor.cs:719
    uses segments.Last().Pose).
    """

    angles: jnp.ndarray
    radii: jnp.ndarray
    valid: jnp.ndarray
    poses: jnp.ndarray

    @property
    def odometry_pose(self) -> jnp.ndarray:
        return self.poses[-1]

    @staticmethod
    def single(angles, radii, valid=None, pose=None) -> "SegmentScan":
        """One whole-revolution segment (the simulator's case, MainWindow.xaml.cs:385)."""
        angles = jnp.asarray(angles, jnp.float32)[None]
        radii = jnp.asarray(radii, jnp.float32)[None]
        if valid is None:
            valid = jnp.ones(angles.shape, bool)
        else:
            valid = jnp.asarray(valid)[None]
        if pose is None:
            pose = jnp.zeros((1, 3), jnp.float32)
        else:
            pose = jnp.asarray(pose, jnp.float32)[None]
        return SegmentScan(angles, radii, valid, pose)


def segments_to_cloud(seg: SegmentScan) -> Scan:
    """De-skew segments into one cloud relative to the newest odometry pose.

    Contract of CoreSLAMProcessor.ScanSegmentsToCloud (CoreSLAMProcessor.cs:187-207):
    ``pose = segment.Pose - odometryPose`` (component-wise — NOT an SE(2) relative
    pose) and each ray becomes
    ``(pose.x + r*cos(angle + pose.z), pose.y + r*sin(angle + pose.z))``.
    """
    rel = seg.poses - seg.odometry_pose  # [S, 3]
    a = seg.angles + rel[:, None, 2]
    x = rel[:, None, 0] + seg.radii * jnp.cos(a)
    y = rel[:, None, 1] + seg.radii * jnp.sin(a)
    pts = jnp.stack([x, y], axis=-1).reshape(-1, 2)
    valid = seg.valid.reshape(-1)
    return Scan(pts, valid, jnp.zeros(3, jnp.float32))


def polar_scan(angles, radii, valid=None) -> Scan:
    """Robot-local polar rays -> cartesian Scan (the simulator's Hector cloud path,
    MainWindow.xaml.cs:167-177)."""
    pts = geometry.polar_to_cartesian(jnp.asarray(radii, jnp.float32),
                                      jnp.asarray(angles, jnp.float32))
    return Scan.from_points(pts, valid)
