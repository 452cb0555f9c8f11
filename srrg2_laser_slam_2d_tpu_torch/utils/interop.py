"""Carry state from the JAX package into the port.

``state_from_numpy`` takes the JAX package's ``FastState`` (cacheT, pose,
scene), ``TrackerState``, ``TrackStats``, ``AlignResult``,
``ProjAlignResult``, ``Cloud``, ``PoseGraph`` or a plain array (a pose, the K-stream
kernel's batched ``cacheB`` / ``poseB`` state, a measurement or odometry
stack), with every leaf given as something ``numpy.asarray`` accepts, and
returns the port's counterpart as tensors on one device. The structures are recognised by their field names,
so this module needs nothing of the JAX package. ``multicue_tracker_from_numpy``
carries a whole ``MultiCueTracker`` over (its state, extrinsics and whether it
is seeded). Tests use them to start both implementations from the same
state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.fast_tracker import FastState
from ..models.tracker import MultiCueTracker, TrackerConfig, TrackerState, TrackStats
from ..ops.icp import AlignResult
from ..ops.projective_align_kernel import ProjAlignResult
from ..solver.pgo import PoseGraph
from .cloud import Cloud

_FLOAT, _BOOL, _INDEX = torch.float32, torch.bool, torch.int64

_LEAF_TYPES = {
    Cloud: {"xy": _FLOAT, "normal": _FLOAT, "valid": _BOOL},
    PoseGraph: {"poses": _FLOAT, "var_valid": _BOOL, "var_fixed": _BOOL,
                "edge_i": _INDEX, "edge_j": _INDEX, "edge_meas": _FLOAT,
                "edge_info": _FLOAT, "edge_valid": _BOOL},
    TrackerState: {"scene": Cloud, "robot_in_local_map": _FLOAT, "last_odom": _FLOAT,
                   "has_odom": _BOOL, "sensor_in_robot": _FLOAT, "clip_cache": Cloud,
                   "clip_cache_rows": _INDEX},
    TrackStats: {"estimate": _FLOAT, "chi": _FLOAT, "num_correspondences": _INDEX,
                 "num_inliers": _INDEX, "chi_inliers": _FLOAT, "iterations": _INDEX,
                 "iter_stats": _FLOAT, "status": _INDEX, "scene_count": _INDEX,
                 "scene_full": _BOOL, "dropped_appends": _INDEX},
    AlignResult: {"estimate": _FLOAT, "chi": _FLOAT, "num_correspondences": _INDEX,
                  "num_inliers": _INDEX, "chi_inliers": _FLOAT, "iterations": _INDEX,
                  "stats": _FLOAT},
    ProjAlignResult: {"estimate": _FLOAT, "chi": _FLOAT, "num_corr": _FLOAT,
                      "num_inliers": _FLOAT, "chi_inl_sum": _FLOAT, "iter_stats": _FLOAT},
}


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def state_from_numpy(obj, device="cpu"):
    """The port's tensors for ``obj`` on ``device``: the structure of the
    same field names (nested clouds included), else a float32 tensor (any
    array: a pose, a batched stream state, a measurement stack)."""
    fields = getattr(obj, "_fields", None)
    if fields is None:
        return _tensor(obj, _FLOAT, device)
    if set(fields) == set(FastState._fields):
        return FastState(cacheT=_tensor(obj.cacheT, _FLOAT, device),
                         pose=_tensor(obj.pose, _FLOAT, device),
                         scene=state_from_numpy(obj.scene, device))
    for cls, leaves in _LEAF_TYPES.items():
        if set(fields) == set(leaves):
            return cls(**{k: (state_from_numpy(getattr(obj, k), device) if dt is Cloud
                              else _tensor(getattr(obj, k), dt, device))
                          for k, dt in leaves.items()})
    raise TypeError(f"no port counterpart for a structure with fields {fields}")


def multicue_tracker_from_numpy(tracker, cfg: TrackerConfig, device="cpu") -> MultiCueTracker:
    """The port's ``MultiCueTracker`` under ``cfg`` in the state of another
    one (the JAX package's): its ``state`` (scene, robot_in_local_map,
    last_odom, has_odom, ...), ``extrinsics`` and seeded flag."""
    out = MultiCueTracker(cfg, np.array(tracker.extrinsics, np.float32), device=device)
    out.state = state_from_numpy(tracker.state, device)
    out._seeded = bool(tracker._seeded)
    return out
