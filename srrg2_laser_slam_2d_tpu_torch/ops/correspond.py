"""The other two correspondence finders. Counterpart of
``srrg2_laser_slam_2d_tpu/ops/correspond.py``: the reference's
``CorrespondenceFinderNN2D`` (grid distance-map matching) and
``CorrespondenceFinderKDTree2D`` (bounded nearest-neighbour matching).

- grid finder: the jump-flooded nearest field of ``ops/distance_map``, one
  gather per moving point;
- brute-force finder: exact bounded nearest neighbour through the [M, N]
  squared-distance matrix |a|^2 + |b|^2 - 2 a.b, its cross term one
  [M, 2] x [2, N] product (float32: the port keeps TF32 off).

Both take leading batch dimensions (one fixed cloud and estimate per batch
element; ``moving`` carries the same batch dimensions).
"""

from __future__ import annotations

import torch

from ..utils import geometry
from ..utils.cloud import Cloud
from . import distance_map
from .icp import Correspondences, _take


def _moving_indices(moving: Cloud) -> torch.Tensor:
    m = moving.capacity
    return torch.arange(m, device=moving.xy.device).expand(moving.valid.shape)


def find_nn_grid(field: distance_map.NearestField, fixed: Cloud, moving: Cloud,
                 estimate: torch.Tensor, max_distance_m: float = 1.0,
                 normal_cos: float = 0.8) -> Correspondences:
    """Distance-map matching: each moving point (moved by ``estimate``)
    takes the field's nearest fixed index of its cell, gated by its true
    distance and the normals' agreement (reference parameters: resolution
    0.05, max_distance_m 1, normal_cos 0.8)."""
    moved_xy = geometry.transform_points(estimate, moving.xy)
    moved_nrm = geometry.rotate_vectors(estimate, moving.normal)
    idx, _ = distance_map.lookup(field, moved_xy)
    safe = torch.clamp(idx, min=0)
    d2 = ((_take(fixed.xy, safe) - moved_xy) ** 2).sum(-1)
    ndot = (_take(fixed.normal, safe) * moved_nrm).sum(-1)
    ok = (moving.valid & (idx >= 0) & torch.gather(fixed.valid, -1, safe)
          & (d2 <= max_distance_m * max_distance_m) & (ndot >= normal_cos))
    return Correspondences(fixed_idx=safe, moving_idx=_moving_indices(moving), valid=ok)


def find_bruteforce_nn(fixed: Cloud, moving: Cloud, estimate: torch.Tensor,
                       max_distance_m: float = 1e-2, normal_cos: float = 0.8
                       ) -> Correspondences:
    """Exact bounded nearest neighbour through a distance matrix (the
    KD-tree finder's result; reference defaults max_distance_m 1e-2,
    normal_cos 0.8). Ties go to the lowest fixed index."""
    moved_xy = geometry.transform_points(estimate, moving.xy)
    moved_nrm = geometry.rotate_vectors(estimate, moving.normal)
    big = 3.0e38
    fx = torch.where(fixed.valid[..., None], fixed.xy, torch.full_like(fixed.xy, big))
    cross = torch.matmul(moved_xy, fx.transpose(-1, -2))
    d2 = (moved_xy * moved_xy).sum(-1, keepdim=True) + (fx * fx).sum(-1)[..., None, :] \
        - 2.0 * cross
    d2 = torch.where(fixed.valid[..., None, :], d2, torch.full_like(d2, big))
    nn = torch.argmin(d2, dim=-1)
    nn_d2 = torch.gather(d2, -1, nn[..., None])[..., 0]
    ndot = (_take(fixed.normal, nn) * moved_nrm).sum(-1)
    ok = moving.valid & (nn_d2 <= max_distance_m * max_distance_m) & (ndot >= normal_cos)
    return Correspondences(fixed_idx=nn, moving_idx=_moving_indices(moving), valid=ok)
