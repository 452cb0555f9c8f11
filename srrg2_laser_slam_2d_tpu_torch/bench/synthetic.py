"""Deterministic synthetic scans with exact ground truth. Counterpart of
``srrg2_laser_slam_2d_tpu/bench/synthetic.py`` (``SyntheticConfig``,
``SyntheticDataset``, ``make_scene``, ``simulate``, ``to_carmen``, and the
corridor world: ``CorridorConfig``, ``corridor_geometry``,
``raycast_ranges``, ``corridor_trajectory``, ``simulate_corridors``).

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



# ---------------------------------------------------------------------------
# Killian-scale corridor world
# ---------------------------------------------------------------------------
# The stand-in for the MIT Killian Court log at its structural scale: a
# corridor network with three nested rectangular loops, thousands of frames,
# in-place corner turns, noisy odometry and walls textured by aperiodic
# alcoves (a straight untextured corridor is longitudinally unobservable to
# ICP). The world and the drive are numpy in float64, as in the JAX package,
# so one seed gives the same dataset in both.

RAYCAST_BLOCK = 16      # poses a block of the batched ray cast on a CUDA device


@dataclass(frozen=True)
class CorridorConfig:
    num_beams: int = 721
    angle_min: float = -np.pi / 2     # SICK-like 180 deg field of view
    angle_max: float = np.pi / 2
    range_min: float = 0.1
    range_max: float = 20.0
    # world layout (metres)
    width: float = 56.0               # outer rectangle x extent
    height: float = 36.0              # outer rectangle y extent
    half_width: float = 1.0           # corridor half width
    wall_spacing: float = 0.05        # wall point sampling
    alcove_depth: float = 0.18        # texture (door frames)
    alcove_period: float = 2.5
    alcove_len: float = 0.4
    # drive
    step: float = 0.15                # m per frame along corridors
    turn_step: float = 0.12           # rad per frame for in-place turns
    # noise
    range_noise: float = 0.01         # per-beam range sigma [m]
    odom_trans_noise: float = 0.008   # per-step odometry sigma [m]
    odom_rot_noise: float = 0.0015    # per-step odometry sigma [rad]
    seed: int = 0


def corridor_centerlines(cfg: CorridorConfig) -> list:
    """Corridor centreline segments: the outer rectangle plus one horizontal
    and one vertical crossing, three independent large loops."""
    w, h = cfg.width, cfg.height
    mid_y, mid_x = h / 2, w / 2
    segs = [
        ((0.0, 0.0), (w, 0.0)),          # bottom
        ((w, 0.0), (w, h)),              # right
        ((w, h), (0.0, h)),              # top
        ((0.0, h), (0.0, 0.0)),          # left
        ((0.0, mid_y), (w, mid_y)),      # middle horizontal
        ((mid_x, 0.0), (mid_x, mid_y)),  # lower-middle vertical
    ]
    return [(np.asarray(a, np.float64), np.asarray(b, np.float64)) for a, b in segs]


def _seg_distance(p: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance of points [N, 2] to segment ab."""
    d = b - a
    L2 = float(d @ d)
    t = np.clip(((p - a) @ d) / max(L2, 1e-12), 0.0, 1.0)
    proj = a + t[:, None] * d
    return np.linalg.norm(p - proj, axis=1)


def corridor_geometry(cfg: CorridorConfig, device=None):
    """The corridor walls: (points Cloud on ``device``, seg_a [S, 2],
    seg_b [S, 2] numpy).

    Walls are densely sampled polylines with inward normals, textured by
    alcoves of random spacing, length and depth (a periodic texture would
    alias a drifted revisit onto a shifted match), with openings carved where
    corridors cross. Consecutive kept samples of one wall are the ray-cast
    targets, so every beam returns as a real rangefinder's does."""
    segs = corridor_centerlines(cfg)
    rng = np.random.default_rng(cfg.seed)
    pts, nrms, owner, chain = [], [], [], []
    chain_id = 0
    for si, (a, b) in enumerate(segs):
        d = b - a
        L = float(np.linalg.norm(d))
        u = d / L
        n = np.array([-u[1], u[0]])
        s = np.arange(0.0, L, cfg.wall_spacing)
        for side in (1.0, -1.0):
            off = np.full_like(s, cfg.half_width)
            pos = rng.uniform(0.5, cfg.alcove_period)
            while pos < L - cfg.alcove_len:
                ln = rng.uniform(0.6, 1.6) * cfg.alcove_len
                depth = rng.uniform(0.7, 1.5) * cfg.alcove_depth
                off = np.where((s >= pos) & (s < pos + ln), cfg.half_width + depth, off)
                pos += ln + rng.uniform(0.5, 1.6) * cfg.alcove_period
            p = a[None, :] + s[:, None] * u[None, :] + (side * off)[:, None] * n[None, :]
            pts.append(p)
            nrms.append(np.tile(-side * n, (len(s), 1)))
            owner.append(np.full(len(s), si))
            chain.append(np.full(len(s), chain_id))
            chain_id += 1
    pts, nrms = np.concatenate(pts), np.concatenate(nrms)
    owner, chain = np.concatenate(owner), np.concatenate(chain)
    # junction openings: drop the wall points that lie inside ANOTHER
    # corridor (closer to its centreline than the corridor half width)
    keep = np.ones(len(pts), bool)
    for si, (a, b) in enumerate(segs):
        inside = _seg_distance(pts, a, b) < cfg.half_width - 0.02
        keep &= ~(inside & (owner != si))
    cloud = cloud_op.from_numpy(pts[keep].astype(np.float32), nrms[keep].astype(np.float32),
                                device=device)
    # micro-segments: consecutive kept samples on one wall chain, close
    # enough to be a wall piece or an alcove jog (carved gaps break the chain)
    kp, kc = pts[keep], chain[keep]
    same = (kc[1:] == kc[:-1]) & (np.linalg.norm(kp[1:] - kp[:-1], axis=1)
                                  < 6.0 * cfg.wall_spacing)
    return cloud, kp[:-1][same].astype(np.float32), kp[1:][same].astype(np.float32)


def corridor_world(cfg: CorridorConfig, device=None) -> Cloud:
    return corridor_geometry(cfg, device)[0]


def raycast_ranges(proj, poses: np.ndarray, seg_a: np.ndarray, seg_b: np.ndarray,
                   device=None) -> np.ndarray:
    """Per-beam ray casting against wall segments: ranges [T, cols] (0 where
    a beam hits nothing within ``range_max``).

    For each pose and beam direction d: the nearest positive intersection
    with any segment (the cross-product parameterization), over
    [beams, segments] a pose. On the CPU this is the JAX package's numpy
    loop, pose by pose; on a CUDA device the same float32 arithmetic batched
    over blocks of ``RAYCAST_BLOCK`` poses, so the [block, beams, segments]
    intermediates stay some hundred MB."""
    device = resolve_device(device)
    poses = np.asarray(poses, np.float32)
    angles = projector_op.beam_angles(proj).numpy()
    if device.type != "cpu":
        return _raycast_torch(proj, poses, seg_a, seg_b, angles, device)
    a = np.asarray(seg_a, np.float32)
    e = np.asarray(seg_b, np.float32) - a
    out = np.zeros((len(poses), proj.cols), np.float32)
    for k, pose in enumerate(poses):
        o, th = pose[:2], pose[2]
        d = np.stack([np.cos(th + angles), np.sin(th + angles)], axis=-1)
        ao = a - o                                             # [S, 2]
        dxe = d[:, None, 0] * e[None, :, 1] - d[:, None, 1] * e[None, :, 0]
        aoxe = ao[None, :, 0] * e[None, :, 1] - ao[None, :, 1] * e[None, :, 0]
        aoxd = ao[None, :, 0] * d[:, None, 1] - ao[None, :, 1] * d[:, None, 0]
        denom = np.where(np.abs(dxe) > 1e-12, dxe, 1e-12)
        t = aoxe / denom
        u = aoxd / denom
        ok = (np.abs(dxe) > 1e-12) & (t > proj.range_min) & (u >= 0.0) & (u <= 1.0)
        t = np.where(ok, t, np.inf)
        r = np.min(t, axis=1)
        out[k] = np.where(np.isfinite(r) & (r <= proj.range_max), r, 0.0)
    return out


def _raycast_torch(proj, poses: np.ndarray, seg_a, seg_b, angles: np.ndarray,
                   device) -> np.ndarray:
    a = torch.as_tensor(np.asarray(seg_a, np.float32), device=device)          # [S, 2]
    e = torch.as_tensor(np.asarray(seg_b, np.float32), device=device) - a
    ang = torch.as_tensor(angles, device=device)                               # [B]
    P = torch.as_tensor(poses, device=device)
    out = torch.empty(len(poses), proj.cols, dtype=torch.float32, device=device)
    ex, ey = e[None, None, :, 0], e[None, None, :, 1]                         # [1, 1, S]
    for lo in range(0, len(poses), RAYCAST_BLOCK):
        blk = P[lo:lo + RAYCAST_BLOCK]
        th = blk[:, 2:3] + ang[None, :]                                        # [b, B]
        dx, dy = torch.cos(th)[..., None], torch.sin(th)[..., None]            # [b, B, 1]
        ao = a[None] - blk[:, None, :2]                                        # [b, S, 2]
        aox, aoy = ao[:, None, :, 0], ao[:, None, :, 1]                        # [b, 1, S]
        dxe = dx * ey - dy * ex
        aoxe = aox * ey - aoy * ex
        aoxd = aox * dy - aoy * dx
        live = dxe.abs() > 1e-12
        denom = torch.where(live, dxe, torch.full_like(dxe, 1e-12))
        t = aoxe / denom
        u = aoxd / denom
        ok = live & (t > proj.range_min) & (u >= 0.0) & (u <= 1.0)
        r = torch.where(ok, t, torch.full_like(t, float("inf"))).amin(dim=-1)
        out[lo:lo + RAYCAST_BLOCK] = torch.where(torch.isfinite(r) & (r <= proj.range_max),
                                                 r, torch.zeros_like(r))
    return out.cpu().numpy()


def corridor_waypoints(cfg: CorridorConfig) -> list:
    """Drive plan: three large loops, each returning over corridor already
    mapped (the loop-closure opportunities), some 450 m in all."""
    w, h = cfg.width, cfg.height
    my, mx = h / 2, w / 2
    return [
        (2.0, 0.0), (w - 2.0, 0.0), (w, 2.0), (w, h - 2.0), (w - 2.0, h),
        (2.0, h), (0.0, h - 2.0), (0.0, 2.0), (2.0, 0.0),          # loop 1: outer
        (mx - 2.0, 0.0), (mx, 2.0), (mx, my - 2.0), (mx - 2.0, my),
        (2.0, my), (0.0, my - 2.0), (0.0, 2.0), (2.0, 0.0),        # loop 2: lower-left
        (w - 2.0, 0.0), (w, 2.0), (w, my - 2.0), (w - 2.0, my),
        (mx + 2.0, my), (mx, my - 2.0), (mx, 2.0), (mx - 2.0, 0.0),
        (2.0, 0.0),                                                 # loop 3: lower-right
    ]


def corridor_trajectory(cfg: CorridorConfig) -> np.ndarray:
    """Ground-truth robot poses: straight legs at ``cfg.step`` with in-place
    corner turns."""
    wps = [np.asarray(p, np.float64) for p in corridor_waypoints(cfg)]
    poses = []
    heading = None
    pos = wps[0]
    for nxt in wps[1:]:
        d = nxt - pos
        L = float(np.linalg.norm(d))
        if L < 1e-9:
            continue
        tgt = float(np.arctan2(d[1], d[0]))
        if heading is None:
            heading = tgt
        dth = np.arctan2(np.sin(tgt - heading), np.cos(tgt - heading))
        n_turn = int(np.ceil(abs(dth) / cfg.turn_step))
        for _ in range(n_turn):
            heading = heading + dth / max(n_turn, 1)
            poses.append([pos[0], pos[1], heading])
        heading = tgt
        n_fwd = int(np.floor(L / cfg.step))
        u = d / L
        for k in range(1, n_fwd + 1):
            p = pos + u * (k * cfg.step)
            poses.append([p[0], p[1], heading])
        pos = pos + u * (n_fwd * cfg.step)
    out = np.asarray(poses, np.float64)
    out[:, 2] = np.arctan2(np.sin(out[:, 2]), np.cos(out[:, 2]))
    return out.astype(np.float32)


def simulate_corridors(cfg: CorridorConfig = CorridorConfig(), poses: np.ndarray | None = None,
                       device=None) -> SyntheticDataset:
    """The whole corridor dataset: world, ground-truth drive and per-beam
    ray-cast scans with range noise (the ray cast on ``device``, the noise
    drawn on the host after it, as in the JAX package). ``poses``
    overrides the trajectory (tests take a slice)."""
    device = resolve_device(device)
    proj = projector_op.PolarProjection.make(
        cols=cfg.num_beams, angle_min=cfg.angle_min, angle_max=cfg.angle_max,
        range_min=cfg.range_min, range_max=cfg.range_max)
    scene, seg_a, seg_b = corridor_geometry(cfg, device)
    gt = corridor_trajectory(cfg) if poses is None else np.asarray(poses, np.float32)
    rng = np.random.default_rng(cfg.seed + 1)
    ranges = raycast_ranges(proj, gt, seg_a, seg_b, device)
    hit = ranges > 0
    ranges = np.where(hit, ranges + rng.normal(scale=cfg.range_noise, size=ranges.shape),
                      ranges).astype(np.float32)
    synth_cfg = SyntheticConfig(
        num_beams=cfg.num_beams, angle_min=cfg.angle_min, angle_max=cfg.angle_max,
        range_min=cfg.range_min, range_max=cfg.range_max, steps=len(gt) - 1, seed=cfg.seed,
        sensor_in_robot=(0.0, 0.0, 0.0))
    return SyntheticDataset(config=synth_cfg, scene=scene, robot_poses=gt,
                            sensor_poses=gt.copy(), ranges=ranges, projection=proj)


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
