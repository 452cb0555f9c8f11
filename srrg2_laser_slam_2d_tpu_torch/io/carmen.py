"""CARMEN log reader: the dataset format of the reference's CARMEN
benchmark suite (MIT Killian Court, Intel Research Lab logs). Counterpart
of ``srrg2_laser_slam_2d_tpu/io/carmen.py``.

Parses the public CARMEN text format:
  FLASER num_readings r0 ... rn-1 x y theta odom_x odom_y odom_theta ts host lts
  ROBOTLASER1 type start fov res max acc rem num r0..rn-1 num_rem x y theta ...
  ODOM x y theta tv rv accel ts host lts
FLASER lines carry both the laser-corrected pose (x, y, theta: the ground
truth of 'corrected' logs) and raw odometry.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .messages import LaserMessage, MessagePack, OdometryMessage


@dataclass
class CarmenScan:
    ranges: np.ndarray
    laser_pose: np.ndarray   # (x, y, theta) of the laser (corrected if available)
    odom_pose: np.ndarray    # (x, y, theta) raw odometry
    timestamp: float
    fov: float = math.pi     # FLASER logs are classically 180 deg
    angle_min: float = -math.pi / 2
    range_max: float = 80.0


def parse_carmen(path: str):
    """Yield CarmenScan / OdometryMessage entries in file order."""
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "FLASER":
                n = int(parts[1])
                vals = np.array(parts[2 : 2 + n], dtype=np.float32)
                rest = parts[2 + n :]
                x, y, th, ox, oy, oth = (float(v) for v in rest[:6])
                ts = float(rest[6]) if len(rest) > 6 else 0.0
                fov = math.pi
                yield CarmenScan(
                    ranges=vals,
                    laser_pose=np.array([x, y, th], np.float32),
                    odom_pose=np.array([ox, oy, oth], np.float32),
                    timestamp=ts,
                    fov=fov,
                    angle_min=-fov / 2,
                )
            elif tag == "ROBOTLASER1":
                # type start_angle fov angular_res max_range accuracy remission_mode
                start = float(parts[2])
                fov = float(parts[3])
                rng_max = float(parts[5])
                n = int(parts[8])
                vals = np.array(parts[9 : 9 + n], dtype=np.float32)
                idx = 9 + n
                n_rem = int(parts[idx]); idx += 1 + n_rem
                x, y, th = (float(v) for v in parts[idx : idx + 3])
                ox, oy, oth = (float(v) for v in parts[idx + 3 : idx + 6])
                ts_idx = idx + 11
                ts = float(parts[ts_idx]) if len(parts) > ts_idx else 0.0
                yield CarmenScan(
                    ranges=vals,
                    laser_pose=np.array([x, y, th], np.float32),
                    odom_pose=np.array([ox, oy, oth], np.float32),
                    timestamp=ts,
                    fov=fov,
                    angle_min=start,
                    range_max=rng_max,
                )
            elif tag == "ODOM":
                x, y, th = (float(v) for v in parts[1:4])
                ts = float(parts[7]) if len(parts) > 7 else 0.0
                yield OdometryMessage(
                    topic="/odom", timestamp=ts, pose=np.array([x, y, th], np.float32)
                )


def load_packs(path: str, max_packs: int | None = None, range_max: float = 80.0):
    """CARMEN scans -> synchronized message packs (laser + odometry), the
    shape the SLAM pipeline consumes. The scan's embedded odometry plays the
    role of the /odom topic; the corrected laser pose is kept as GT."""
    packs, gt = [], []
    seq = 0
    for item in parse_carmen(path):
        if not isinstance(item, CarmenScan):
            continue
        n = len(item.ranges)
        laser = LaserMessage(
            topic="/scan",
            seq=seq,
            timestamp=item.timestamp,
            angle_min=item.angle_min,
            angle_max=item.angle_min + item.fov,
            angle_increment=item.fov / max(n, 1),
            range_min=0.0,
            range_max=min(item.range_max, range_max),
            ranges=item.ranges,
        )
        odom = OdometryMessage(topic="/odom", seq=seq, timestamp=item.timestamp, pose=item.odom_pose)
        packs.append(
            MessagePack(topic="pack", seq=seq, timestamp=item.timestamp, messages=[laser, odom])
        )
        gt.append(np.concatenate([[item.timestamp], item.laser_pose]))
        seq += 1
        if max_packs is not None and seq >= max_packs:
            break
    return packs, np.array(gt, np.float32)
