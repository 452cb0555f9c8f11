"""SLAM benchmark suite: ground-truth association, SE(2) alignment, ATE
statistics and the regression gate. Counterpart of
``srrg2_laser_slam_2d_tpu/bench/suite.py`` (numpy only)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io import tum as tum_io


@dataclass
class RegressionThresholds:
    """Bounds of the reference benchmarks' exit-code gate."""

    max_mean_translation: tuple = (25.0, 25.0)
    max_std_translation: tuple = (100.0, 100.0)
    max_mean_rotation: float = 1.0
    max_std_rotation: float = 1.0


KILLIAN_THRESHOLDS = RegressionThresholds((25.0, 25.0), (100.0, 100.0), 1.0, 1.0)
SIMUL_THRESHOLDS = RegressionThresholds((0.1, 0.1), (0.5, 0.5), 1.0, 1.0)
# the 2,871-frame synthetic corridor: sub-meter ATE
CORRIDOR_THRESHOLDS = RegressionThresholds((1.0, 1.0), (2.0, 2.0), 0.5, 0.5)


@dataclass
class BenchmarkSuite:
    """Collects timestamped pose estimates and compares them with GT."""

    gt_timestamps: np.ndarray = None     # [N]
    gt_poses: np.ndarray = None          # [N, 3]
    estimates: list = field(default_factory=list)  # (timestamp, pose, duration)

    def set_ground_truth(self, timestamps, poses) -> None:
        self.gt_timestamps = np.asarray(timestamps, np.float64)
        self.gt_poses = np.asarray(poses, np.float32)

    def set_pose_estimate(self, pose, timestamp: float, duration: float = 0.0) -> None:
        self.estimates.append((float(timestamp), np.asarray(pose, np.float32), duration))

    def _matched(self):
        """Associate every estimate with the GT pose nearest in time."""
        if self.gt_timestamps is None:
            raise RuntimeError("ground truth not loaded")
        est_t = np.array([e[0] for e in self.estimates])
        est_p = np.stack([e[1] for e in self.estimates])
        idx = np.clip(np.searchsorted(self.gt_timestamps, est_t), 0,
                      len(self.gt_timestamps) - 1)
        prev = np.clip(idx - 1, 0, len(self.gt_timestamps) - 1)
        use_prev = (np.abs(self.gt_timestamps[prev] - est_t)
                    < np.abs(self.gt_timestamps[idx] - est_t))
        return est_p, self.gt_poses[np.where(use_prev, prev, idx)]

    def compute(self, align: bool = True) -> dict:
        """Absolute trajectory error statistics, after removing the rigid
        gauge between the trajectories when ``align``."""
        est, gt = self._matched()
        if align:
            est = _align_se2(est, gt)
        d = est[:, :2] - gt[:, :2]
        dth = np.arctan2(np.sin(est[:, 2] - gt[:, 2]), np.cos(est[:, 2] - gt[:, 2]))
        return {
            "mean_translation": np.abs(d).mean(axis=0),
            "std_translation": d.std(axis=0),
            "rmse_translation": float(np.sqrt((d ** 2).sum(axis=1).mean())),
            "mean_rotation": float(np.abs(dth).mean()),
            "std_rotation": float(dth.std()),
            "num_poses": len(est),
            "mean_duration": float(np.mean([e[2] for e in self.estimates])),
        }

    def is_regression(self, thr: RegressionThresholds, stats: dict | None = None) -> bool:
        """True when any statistic leaves its bound."""
        s = stats or self.compute()
        mt, st = s["mean_translation"], s["std_translation"]
        return bool(
            mt[0] > thr.max_mean_translation[0] or mt[1] > thr.max_mean_translation[1]
            or abs(st[0]) > thr.max_std_translation[0]
            or abs(st[1]) > thr.max_std_translation[1]
            or s["mean_rotation"] > thr.max_mean_rotation
            or s["std_rotation"] > thr.max_std_rotation)

    def write_trajectory(self, path: str) -> None:
        tum_io.write_tum(path, [e[0] for e in self.estimates],
                         [e[1] for e in self.estimates])


def _align_se2(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Closed-form SE(2) alignment of est onto gt (2D Umeyama, no scale)."""
    a, b = est[:, :2], gt[:, :2]
    ca, cb = a.mean(0), b.mean(0)
    h = (a - ca).T @ (b - cb)
    theta = np.arctan2(h[0, 1] - h[1, 0], h[0, 0] + h[1, 1])
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s], [s, c]])
    out = est.copy()
    out[:, :2] = a @ R.T + (cb - R @ ca)
    out[:, 2] = est[:, 2] + theta
    return out
