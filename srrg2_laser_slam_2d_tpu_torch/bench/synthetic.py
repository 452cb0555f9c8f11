"""Deterministic synthetic scans with exact ground truth. Counterpart of
``srrg2_laser_slam_2d_tpu/bench/synthetic.py`` (``SyntheticConfig``,
``SyntheticDataset``, ``make_scene``, ``simulate``).

World: a circle (r = 3.5, 2048 points) plus an L-corner (1024 points) at
pose (2, 0, pi/4). A polar laser scans it from a seeded random-walk
trajectory; every scan comes with its exact sensor pose. The trajectory is
numpy (float64, as in the JAX package, so both draw the same walk from one
seed); the scans are one batched z-buffer projection of the world through
``ops/projector.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..ops import projector as projector_op
from ..utils import cloud as cloud_op
from ..utils.cloud import Cloud


@dataclass(frozen=True)
class SyntheticConfig:
    num_beams: int = 1024
    angle_min: float = -np.pi * 0.4
    angle_max: float = np.pi * 0.4
    range_min: float = 0.01
    range_max: float = 1000.0
    circle_radius: float = 3.5
    circle_points: int = 2048
    corner_points: int = 1024
    steps: int = 100
    max_variance: float = 0.1   # per-step motion lies in +-max_variance / 2
    drift: tuple = (0.0, 0.0, 0.0)   # deterministic per-step motion added to the walk
    seed: int = 0
    sensor_in_robot: tuple = (0.2, 0.2, 0.1)


@dataclass
class SyntheticDataset:
    config: SyntheticConfig
    scene: Cloud                      # world point cloud
    robot_poses: np.ndarray           # [T, 3] robot-in-world (ground truth)
    sensor_poses: np.ndarray          # [T, 3] sensor-in-world (ground truth)
    ranges: np.ndarray                # [T, num_beams]
    projection: projector_op.PolarProjection = field(default=None)


def make_scene(cfg: SyntheticConfig, device=None) -> Cloud:
    """The circle and corner world."""
    a = np.arange(cfg.circle_points) * (2 * np.pi / cfg.circle_points)
    circle = np.stack([cfg.circle_radius * np.cos(a), cfg.circle_radius * np.sin(a)], axis=1)
    # corner: two straight segments of lengths 2 and 3 from the origin
    l0, l1 = 2.0, 3.0
    n = cfg.corner_points
    step = (l0 + l1) / n
    n0 = int(l0 / step)
    seg0 = np.stack([step * np.arange(n0), np.zeros(n0)], axis=1)
    n1 = n - n0
    seg1 = np.stack([np.zeros(n1 - 1), -step * np.arange(1, n1)], axis=1)
    corner = np.concatenate([seg0, seg1], axis=0)
    c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
    R = np.array([[c, -s], [s, c]])
    corner = corner @ R.T + np.array([2.0, 0.0])
    pts = np.concatenate([circle, corner], axis=0).astype(np.float32)
    return cloud_op.from_numpy(pts, device=device)


def _compose(a, b):
    ca, sa = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + ca * b[0] - sa * b[1], a[1] + sa * b[0] + ca * b[1],
                     np.arctan2(np.sin(a[2] + b[2]), np.cos(a[2] + b[2]))])


def simulate(cfg: SyntheticConfig = SyntheticConfig(), device=None) -> SyntheticDataset:
    """The full dataset: ground-truth trajectory and simulated range scans
    (computed on ``device``, returned as numpy)."""
    device = resolve_device(device)
    proj = projector_op.PolarProjection.make(
        cols=cfg.num_beams, angle_min=cfg.angle_min, angle_max=cfg.angle_max,
        range_min=cfg.range_min, range_max=cfg.range_max)
    scene = make_scene(cfg, device)
    rng = np.random.default_rng(cfg.seed)
    sensor_in_robot = np.array(cfg.sensor_in_robot)

    robot = np.zeros(3)
    robot_poses, sensor_poses = [], []
    for step in range(cfg.steps + 1):
        if step > 0:
            motion = rng.uniform(-0.5, 0.5, size=3) * cfg.max_variance + np.asarray(cfg.drift)
            robot = _compose(robot, motion)
        robot_poses.append(robot.copy())
        sensor_poses.append(_compose(robot, sensor_in_robot))
    robot_poses = np.stack(robot_poses).astype(np.float32)
    sensor_poses = np.stack(sensor_poses).astype(np.float32)

    # every scan in one batched projection: poses [T, 3] against the world
    canvas, _ = projector_op.project(proj, torch.from_numpy(sensor_poses).to(device), scene)
    ranges = projector_op.ranges_from_canvas(canvas).cpu().numpy().astype(np.float32)
    return SyntheticDataset(config=cfg, scene=scene, robot_poses=robot_poses,
                            sensor_poses=sensor_poses, ranges=ranges, projection=proj)
