"""Z-buffered polar projection as one kernel. Counterpart of
``srrg2_laser_slam_2d_tpu/ops/pallas_projector.py`` (``project_local_pallas``).

Per beam the closest depth and the index of the point that holds it, with
the range gates of ``ops/projector.project_local``; the lowest index wins
equal depths. Beam assignment uses the kernels' polynomial arctangent
(``_beam_kernels.atan2_poly``), so a point on a beam-bin edge can fall on
the other side than under ``torch.atan2``. The CUDA kernel is
``csrc/projector_kernel.cu`` (one 64-bit ``atomicMin`` per point on the key
depth bits, point index); ``project_local_plain`` is its plain PyTorch
version, a dense [N, B] compare.
"""

from __future__ import annotations

import ctypes

import torch

from . import _beam_kernels as bk
from . import _cuda
from .projector import Canvas, PolarProjection

_EMPTY_DEPTH = 3.0e38
# floating-point operations to assign one sensor-frame point to its beam:
# 4 for the depth, 25 for the polynomial arctangent, 3 for the column, 5 gates
FLOPS_PER_POINT = 37
# launches of the CUDA kernel (reset by callers that count a run)
launches = 0


def cols_padded(proj: PolarProjection) -> int:
    return ((proj.cols + 127) // 128) * 128


class _ProjectorParams(ctypes.Structure):
    """Mirror of ``ProjectorParams`` in csrc/projector_kernel.cu."""

    _fields_ = [("n", ctypes.c_int), ("B", ctypes.c_int), ("cols", ctypes.c_int),
                ("f", ctypes.c_float), ("c", ctypes.c_float),
                ("range_min", ctypes.c_float), ("range_max", ctypes.c_float)]


def _canvas(proj: PolarProjection, depth: torch.Tensor, idx: torch.Tensor) -> Canvas:
    depth, idx = depth[: proj.cols], idx[: proj.cols].to(torch.int64)
    v = idx >= 0
    return Canvas(depth=torch.where(v, depth, torch.full_like(depth, _EMPTY_DEPTH)),
                  idx=idx, valid=v)


def project_local_plain(proj: PolarProjection, xy: torch.Tensor,
                        valid: torch.Tensor) -> Canvas:
    """Plain PyTorch version: dense masked minimum over [N, B], the first
    (lowest) index among the points at the minimum."""
    n = xy.shape[0]
    d, colf, ok = bk.beam_fields(xy[:, 0], xy[:, 1], valid, proj)
    dmin, _, dm = bk.tied_min_onehot(d, colf, ok, cols_padded(proj))
    rows = torch.arange(n, device=xy.device)[:, None]
    at_min = (dm <= dmin[None, :]) & (dm < 1.0e30)
    first = torch.where(at_min, rows, torch.full_like(rows, n)).min(dim=0).values
    has = dmin < 1.0e30
    return _canvas(proj, dmin, torch.where(has, first, torch.full_like(first, -1)))


def project_local(proj: PolarProjection, xy: torch.Tensor, valid: torch.Tensor) -> Canvas:
    """Canvas of a sensor-frame cloud (xy [N, 2], valid [N] bool). CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    global launches
    if xy.device.type == "cpu":
        return project_local_plain(proj, xy, valid)
    if xy.device.type != "cuda":
        raise ValueError(f"unsupported device {xy.device}")
    dev = xy.device
    xy, _, valid = _cuda.cloud_tensors("cloud", xy, None, valid, dev)
    B = cols_padded(proj)
    if B > 1024:
        raise ValueError(f"{proj.cols} beams: the kernel holds at most 1024")
    depth = torch.empty(B, dtype=torch.float32, device=dev)
    idx = torch.empty(B, dtype=torch.int32, device=dev)
    params = _ProjectorParams(n=xy.shape[0], B=B, cols=proj.cols, f=proj.f, c=proj.c,
                              range_min=proj.range_min, range_max=proj.range_max)
    lib = _cuda.load("projector_kernel")
    with torch.cuda.device(dev):
        err = lib.project_local(xy.data_ptr(), valid.data_ptr(), depth.data_ptr(),
                                idx.data_ptr(), ctypes.addressof(params),
                                _cuda.stream_of(dev))
    if err != 0:
        raise RuntimeError(f"projector kernel launch failed: {_cuda.error_string(err)}")
    launches += 1
    return _canvas(proj, depth, idx)
