"""SE(2) geometry on ``[..., 3]`` pose vectors ``(x, y, theta)``.

Counterpart of ``srrg2_laser_slam_2d_tpu/utils/geometry.py``: the same
functions over torch tensors, broadcasting over leading dimensions.
``compose`` wraps the angle to (-pi, pi]; ``inverse`` does not.
"""

from __future__ import annotations

import torch


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def v2t(v: torch.Tensor) -> torch.Tensor:
    """Pose vector [..., 3] -> homogeneous matrix [..., 3, 3]."""
    x, y, t = v[..., 0], v[..., 1], v[..., 2]
    c, s = torch.cos(t), torch.sin(t)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    rows = [
        torch.stack([c, -s, x], dim=-1),
        torch.stack([s, c, y], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def t2v(T: torch.Tensor) -> torch.Tensor:
    """Homogeneous matrix [..., 3, 3] -> pose vector [..., 3]."""
    t = torch.atan2(T[..., 1, 0], T[..., 0, 0])
    return torch.stack([T[..., 0, 2], T[..., 1, 2], t], dim=-1)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Vector of T(a) @ T(b), angle wrapped."""
    xa, ya, ta = a[..., 0], a[..., 1], a[..., 2]
    xb, yb, tb = b[..., 0], b[..., 1], b[..., 2]
    c, s = torch.cos(ta), torch.sin(ta)
    x = xa + c * xb - s * yb
    y = ya + s * xb + c * yb
    return torch.stack([x, y, wrap_angle(ta + tb)], dim=-1)


def inverse(a: torch.Tensor) -> torch.Tensor:
    """Vector of T(a)^-1."""
    x, y, t = a[..., 0], a[..., 1], a[..., 2]
    c, s = torch.cos(t), torch.sin(t)
    return torch.stack([-(c * x + s * y), -(-s * x + c * y), -t], dim=-1)


def relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """T(a)^-1 @ T(b) as a pose vector."""
    return compose(inverse(a), b)


def transform_points(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """R(theta) p + t for pose [..., 3] and points [..., N, 2]."""
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    x, y = pts[..., 0], pts[..., 1]
    xo = c * x - s * y + pose[..., 0, None]
    yo = s * x + c * y + pose[..., 1, None]
    return torch.stack([xo, yo], dim=-1)


def rotate_vectors(pose: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Rotation part of pose [..., 3] applied to vectors [..., N, 2]."""
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    x, y = vecs[..., 0], vecs[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def rot(theta: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 2, 2] from angle [...]."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def exp_se2(v: torch.Tensor) -> torch.Tensor:
    """The increment (vx, vy, omega) as a pose vector. The Gauss-Newton
    updates pre-multiply ``v2t(dx)``, treating the increment as a small pose
    rather than a true exponential, so this is the identity."""
    return v


def get3d_from_2d_pose(v: torch.Tensor) -> torch.Tensor:
    """Pose vector (x, y, theta) -> 4x4 3D isometry [..., 4, 4]."""
    x, y, t = v[..., 0], v[..., 1], v[..., 2]
    c, s = torch.cos(t), torch.sin(t)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    rows = [
        torch.stack([c, -s, zero, x], dim=-1),
        torch.stack([s, c, zero, y], dim=-1),
        torch.stack([zero, zero, one, zero], dim=-1),
        torch.stack([zero, zero, zero, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def t2tqxyzw(v: torch.Tensor) -> torch.Tensor:
    """Pose vector -> (x, y, z, qx, qy, qz, qw), the TUM trajectory row of a
    2D pose."""
    x, y, t = v[..., 0], v[..., 1], v[..., 2]
    half = 0.5 * t
    zero = torch.zeros_like(x)
    return torch.stack([x, y, zero, zero, zero, torch.sin(half), torch.cos(half)], dim=-1)
