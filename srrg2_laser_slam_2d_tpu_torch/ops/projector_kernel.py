"""Z-buffered polar projection as one kernel. Counterpart of
``srrg2_laser_slam_2d_tpu/ops/pallas_projector.py`` (``project_local_pallas``).

Per beam the closest depth and the index of the point that holds it, with
the range gates of ``ops/projector.project_local``; the lowest index wins
equal depths. Beam assignment uses the kernels' polynomial arctangent
(``_beam_kernels.atan2_poly``), so a point on a beam-bin edge can fall on
the other side than under ``torch.atan2``. The CUDA kernel is
``csrc/projector_kernel.cu``: one launch for any leading batch of clouds,
a thread-block cluster of ``cluster_blocks(N)`` blocks per cloud, one
64-bit ``atomicMin`` per point on the key (depth bits, point index) in its
block's shared memory, the blocks' keys met at each beam's owner block,
and the ``Canvas`` written as the callers take it.
``project_local_plain`` is its plain PyTorch version, a dense [N, B]
compare per cloud.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter

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
# calls that launched the kernel, by (points per cloud, clouds)
calls: Counter = Counter()
# threads a block of kernels 7 and 8; blocks of a cluster at most (the
# portable cluster size)
BLOCK_THREADS = 1024
MAX_CLUSTER = 8


def cluster_blocks(n: int) -> int:
    """Blocks (SMs) that kernels 7 and 8 spread a cloud of ``n`` points
    over: one up to ``BLOCK_THREADS`` points, else one per
    ``BLOCK_THREADS`` points up to ``MAX_CLUSTER`` (a thread then holds one
    or two points up to 16,384). The launchers take it as it is: a batch
    of more clouds than the card holds such clusters at once runs in more
    than one wave."""
    return 1 if n <= BLOCK_THREADS else min(MAX_CLUSTER, -(-n // BLOCK_THREADS))


def cols_padded(proj: PolarProjection) -> int:
    return ((proj.cols + 127) // 128) * 128


class _ProjectorParams(ctypes.Structure):
    """Mirror of ``ProjectorParams`` in csrc/projector_kernel.cu."""

    _fields_ = [("n", ctypes.c_int), ("B", ctypes.c_int), ("cols", ctypes.c_int),
                ("f", ctypes.c_float), ("c", ctypes.c_float),
                ("range_min", ctypes.c_float), ("range_max", ctypes.c_float),
                ("clouds", ctypes.c_int), ("cluster", ctypes.c_int)]


# xy, valid, depth, idx, has, params, stream
PROJECT_LOCAL = _cuda.Entry("projector_kernel", "project_local", [_cuda.PTR] * 7)


def _plain_one(proj: PolarProjection, xy: torch.Tensor, valid: torch.Tensor) -> Canvas:
    n = xy.shape[0]
    d, colf, ok = bk.beam_fields(xy[:, 0], xy[:, 1], valid, proj)
    dmin, _, dm = bk.tied_min_onehot(d, colf, ok, cols_padded(proj))
    rows = torch.arange(n, device=xy.device)[:, None]
    at_min = (dm <= dmin[None, :]) & (dm < 1.0e30)
    first = torch.where(at_min, rows, torch.full_like(rows, n)).min(dim=0).values
    has = (dmin < 1.0e30)[: proj.cols]
    return Canvas(depth=torch.where(has, dmin[: proj.cols],
                                    torch.full_like(dmin[: proj.cols], _EMPTY_DEPTH)),
                  idx=torch.where(has, first[: proj.cols], torch.full_like(first[: proj.cols], -1)),
                  valid=has)


def project_local_plain(proj: PolarProjection, xy: torch.Tensor,
                        valid: torch.Tensor) -> Canvas:
    """Plain PyTorch version: per cloud a dense masked minimum over [N, B],
    the first (lowest) index among the points at the minimum."""
    batch, n = xy.shape[:-2], xy.shape[-2]
    if not batch:
        return _plain_one(proj, xy, valid)
    fx, fv = xy.reshape(-1, n, 2), valid.reshape(-1, n)
    outs = [_plain_one(proj, fx[k], fv[k]) for k in range(fx.shape[0])]
    return Canvas(*(torch.stack(f).reshape(batch + (proj.cols,)) for f in zip(*outs)))


def project_local(proj: PolarProjection, xy: torch.Tensor, valid: torch.Tensor) -> Canvas:
    """Canvas of sensor-frame clouds (xy [..., N, 2], valid [..., N] bool):
    depth [..., cols] (3e38 where empty), idx [..., cols] int64 (-1 where
    empty), valid [..., cols]. CUDA tensors launch the kernel once for the
    whole batch; CPU tensors take the plain version."""
    global launches
    if not _cuda.on_card(xy):
        return project_local_plain(proj, xy, valid)
    dev = xy.device
    batch, n = xy.shape[:-2], xy.shape[-2]
    if xy.dtype != torch.float32 or xy.shape[-1] != 2 or valid.dtype != torch.bool \
            or valid.shape != xy.shape[:-1] or valid.device != dev:
        raise ValueError(f"cloud: need float32 [..., N, 2] points and a bool [..., N] mask on "
                         f"{dev}, got {xy.dtype} {tuple(xy.shape)} and {valid.dtype} "
                         f"{tuple(valid.shape)} on {valid.device}")
    B = cols_padded(proj)
    if B > 1024:
        raise ValueError(f"{proj.cols} beams: the kernel holds at most 1024")
    xy, valid = xy.contiguous(), valid.contiguous()
    shape = batch + (proj.cols,)
    depth = torch.empty(shape, dtype=torch.float32, device=dev)
    idx = torch.empty(shape, dtype=torch.int64, device=dev)
    has = torch.empty(shape, dtype=torch.bool, device=dev)
    clouds = math.prod(batch)
    if clouds == 0:
        return Canvas(depth, idx, has)
    params = _ProjectorParams(n, B, proj.cols, proj.f, proj.c, proj.range_min, proj.range_max,
                              clouds, cluster_blocks(n))
    PROJECT_LOCAL(dev, xy.data_ptr(), valid.data_ptr(), depth.data_ptr(), idx.data_ptr(),
                  has.data_ptr(), ctypes.addressof(params))
    launches += 1
    calls[(n, clouds)] += 1
    return Canvas(depth, idx, has)
