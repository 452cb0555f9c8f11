"""Absolute trajectory error against a ground truth, the arithmetic of the
port's ``bench/suite.py`` (nearest-in-time association, the closed-form
SE(2) alignment, per-axis mean and spread), copied as the benchmark was
written. NumPy only."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_tum(path: Path) -> tuple[np.ndarray, np.ndarray]:
    """(timestamps [N], poses [N, 3]) of a TUM file, yaw from the quaternion."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 8 or parts[0].startswith("#"):
                continue
            t, x, y, _, qx, qy, qz, qw = (float(v) for v in parts[:8])
            ts.append(t)
            poses.append([x, y, np.arctan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))])
    return np.asarray(ts), np.asarray(poses, np.float32)


def _align_se2(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
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


def statistics(trajectory, gt_t: np.ndarray, gt_p: np.ndarray) -> dict:
    """``trajectory``: [(timestamp, pose)] -> the gate's statistics."""
    est_t = np.array([t for t, _ in trajectory])
    est = np.stack([np.asarray(p, np.float32)[:3] for _, p in trajectory])
    idx = np.clip(np.searchsorted(gt_t, est_t), 0, len(gt_t) - 1)
    prev = np.clip(idx - 1, 0, len(gt_t) - 1)
    use_prev = np.abs(gt_t[prev] - est_t) < np.abs(gt_t[idx] - est_t)
    gt = gt_p[np.where(use_prev, prev, idx)]
    est = _align_se2(est, gt)
    d = est[:, :2] - gt[:, :2]
    dth = np.arctan2(np.sin(est[:, 2] - gt[:, 2]), np.cos(est[:, 2] - gt[:, 2]))
    mean, std = np.abs(d).mean(axis=0), d.std(axis=0)
    return {"ate_mean_x_m": float(mean[0]), "ate_mean_y_m": float(mean[1]),
            "ate_std_x_m": float(abs(std[0])), "ate_std_y_m": float(abs(std[1])),
            "ate_mean_rotation_rad": float(np.abs(dth).mean()),
            "ate_std_rotation_rad": float(dth.std()),
            "ate_rmse_m": float(np.sqrt((d ** 2).sum(axis=1).mean()))}
