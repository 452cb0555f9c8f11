"""Deterministic synthetic scans with exact ground truth. Counterpart of
``srrg2_laser_slam_2d_tpu/bench/synthetic.py`` (``SyntheticConfig``,
``SyntheticDataset``, ``make_scene``, ``simulate``, ``to_carmen``).

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


def to_carmen(ds: SyntheticDataset, path: str) -> None:
    """Write the dataset as a CARMEN log of ROBOTLASER1 lines (which carry
    the laser geometry): the laser pose is the sensor's ground truth, the
    odometry the robot's, one scan every 0.1 s. The same bytes as the JAX
    package's ``to_carmen`` on the same arrays."""
    cfg = ds.config
    fov = cfg.angle_max - cfg.angle_min
    res = fov / cfg.num_beams
    with open(path, "w") as f:
        f.write("# synthetic CARMEN log (tpu-laser-slam-2d)\n")
        for t in range(len(ds.ranges)):
            n = cfg.num_beams
            rs = " ".join(f"{r:.4f}" for r in ds.ranges[t])
            lp = ds.sensor_poses[t]
            op = ds.robot_poses[t]
            ts = 0.1 * t
            f.write(
                f"ROBOTLASER1 0 {cfg.angle_min:.6f} {fov:.6f} {res:.6f} "
                f"{min(cfg.range_max, 80.0):.2f} 0.01 0 {n} {rs} 0 "
                f"{lp[0]:.6f} {lp[1]:.6f} {lp[2]:.6f} "
                f"{op[0]:.6f} {op[1]:.6f} {op[2]:.6f} "
                f"0 0 0 0 0 {ts:.4f} synth {ts:.4f}\n"
            )


def _min_rows(xy: torch.Tensor, valid: torch.Tensor, view) -> torch.Tensor:
    """[N, B] bool: row i lies at the closest depth of beam b, with the cloud
    moved by the pose T of ``view`` = (projection, T, padded beams B) (the
    aligners' moving z-buffer; T = 0 gives the fixed canvas)."""
    from ..ops import _beam_kernels as bk

    proj, T, B = view
    x, y = xy[:, 0], xy[:, 1]
    f = bk.moving_fields((x, y, x, y, valid), T.to(xy), proj)
    _, hot, _ = bk.tied_min_onehot(f["d"], f["col_i"].to(torch.float32), f["okp"], B)
    return hot > 0


def tie_counts(cloud: Cloud, view) -> set:
    """How many rows tie at the closest depth on each beam that ``cloud``
    hits, seen as ``view`` = (projection, pose T, padded beams B) gives it."""
    return set(_min_rows(cloud.xy, cloud.valid, view).sum(dim=0).tolist())


def with_tied_rows(cloud: Cloud, seed: int, beam_indexed: bool = False, view=None) -> Cloud:
    """``cloud`` with two- and three-way bitwise depth ties, the aligner
    kernels' tie input: six valid rows (drawn with ``seed``) get one copy
    and six two copies, each copy's normal turned by +-0.1 rad, so the mean
    over the tied rows differs from every one of them. The copies are
    appended or, for a beam-indexed cloud (one row per beam), written over
    the rows that follow each drawn row. With ``view`` = (projection, pose
    T, padded beams B) the rows are drawn among those alone at their
    beam's closest depth there, so that every copy ties at the minimum."""
    rng = np.random.default_rng(seed)
    pool = cloud.valid.clone()
    if view is not None:
        at_min = _min_rows(cloud.xy, cloud.valid, view)
        pool &= (at_min & (at_min.sum(dim=0) == 1)[None]).any(dim=1)
    xy, nm, valid = (x.cpu().numpy().copy() for x in (cloud.xy, cloud.normal, cloud.valid))
    picks = rng.choice(np.flatnonzero(pool.cpu().numpy()[:-3]), 12, replace=False)
    c, s = np.cos(0.1), np.sin(0.1)
    rows, cxy, cnm = [], [], []
    for i, r in enumerate(picks):
        for k in range(1 + (i >= 6)):
            turn = np.array([[c, -s], [s, c]] if k == 0 else [[c, s], [-s, c]], np.float32)
            rows.append(r + 1 + k)
            cxy.append(xy[r])
            cnm.append(turn @ nm[r])
    if beam_indexed:
        xy[rows], nm[rows], valid[rows] = cxy, cnm, True
    else:
        xy, nm = np.concatenate([xy, np.stack(cxy)]), np.concatenate([nm, np.stack(cnm)])
        valid = np.concatenate([valid, np.ones(len(cxy), bool)])
    dev = cloud.xy.device
    return Cloud(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        xy.astype(np.float32), nm.astype(np.float32), valid)))
