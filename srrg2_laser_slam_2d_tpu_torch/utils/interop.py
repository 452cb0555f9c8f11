"""Carry state from the JAX package into the port.

``state_from_numpy`` takes the JAX package's ``FastState`` (cacheT, pose,
scene), ``Cloud``, ``PoseGraph`` or a plain array (a pose, the K-stream
kernel's batched ``cacheB`` / ``poseB`` state, a measurement or odometry
stack), with every leaf given as something ``numpy.asarray`` accepts, and
returns the port's counterpart as tensors on one device. The structures are recognised by their field names,
so this module needs nothing of the JAX package. Tests use it to start both
implementations from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.fast_tracker import FastState
from ..solver.pgo import PoseGraph
from .cloud import Cloud

_FLOAT, _BOOL, _INDEX = torch.float32, torch.bool, torch.int64

_LEAF_TYPES = {
    Cloud: {"xy": _FLOAT, "normal": _FLOAT, "valid": _BOOL},
    PoseGraph: {"poses": _FLOAT, "var_valid": _BOOL, "var_fixed": _BOOL,
                "edge_i": _INDEX, "edge_j": _INDEX, "edge_meas": _FLOAT,
                "edge_info": _FLOAT, "edge_valid": _BOOL},
}


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def state_from_numpy(obj, device="cpu"):
    """The port's tensors for ``obj`` on ``device``: a FastState, Cloud or
    PoseGraph for the structures of the same name, else a float32 tensor
    (any array: a pose, a batched stream state, a measurement stack)."""
    fields = getattr(obj, "_fields", None)
    if fields is None:
        return _tensor(obj, _FLOAT, device)
    if set(fields) == set(FastState._fields):
        return FastState(cacheT=_tensor(obj.cacheT, _FLOAT, device),
                         pose=_tensor(obj.pose, _FLOAT, device),
                         scene=state_from_numpy(obj.scene, device))
    for cls, leaves in _LEAF_TYPES.items():
        if set(fields) == set(leaves):
            return cls(**{k: _tensor(getattr(obj, k), dt, device)
                          for k, dt in leaves.items()})
    raise TypeError(f"no port counterpart for a structure with fields {fields}")
