"""The shift z-buffer probe as one kernel. Counterpart of the Pallas probe
of ``tests/test_fast_tracker.py:81`` (``test_shift_zbuffer_matches_projector``):
beam-indexed cells (lane r is the cell last seen on beam r, as in the
merge-canvas cache) are taken to their beams at the identity pose and
z-buffered within +-``max_shift`` beams of their lane, the closest depth
winning and the highest lane among equal depths. It is the z-buffer of the
frame kernel's lean merge alone; the JAX test holds it to the projector's
z-buffer. The CUDA kernel is ``csrc/beam_zbuffer_kernel.cu``;
``beam_zbuffer_probe_plain`` is its plain PyTorch version.

Layouts: geoT [8, B] rows x, y, nx, ny, valid, payload (the home row), 0,
0; the output [8, B] rows depth (1e30 where no cell landed), the winner's
x, y and payload, has-winner, 0, 0, 0.
"""

from __future__ import annotations

import torch

from ..utils.cloud import Cloud
from . import _beam_kernels as bk
from . import _cuda
from .projector import PolarProjection
from .projector_kernel import cols_padded

# launches of the CUDA kernel (reset by callers that count a run)
launches = 0
MAX_SHIFT = 32
# operations per lane: 43 for the transform and beam assignment, 4 for the
# band test and the two compares
FLOPS_PER_LANE = 47
# geoT, out, B, cols, f, c, range_min, range_max, max_shift, stream
BEAM_ZBUFFER = _cuda.Entry("beam_zbuffer_kernel", "beam_zbuffer",
                           [_cuda.PTR] * 2 + [_cuda.INT] * 2 + [_cuda.FLOAT] * 4
                           + [_cuda.INT, _cuda.PTR])
# B, stream: an empty kernel at the probe's launch shape
BEAM_ZBUFFER_FLOOR = _cuda.Entry("beam_zbuffer_kernel", "beam_zbuffer_floor",
                                 [_cuda.INT, _cuda.PTR])


def pack_cells(cells: Cloud, proj: PolarProjection) -> torch.Tensor:
    """geoT [8, B] of beam-indexed cells [cols, ...]: their points, normals,
    validity and home row, padded to the canvas width."""
    n, B = cells.capacity, cols_padded(proj)
    dev = cells.xy.device
    geo = torch.cat([cells.xy.T, cells.normal.T, cells.valid.to(torch.float32)[None],
                     torch.arange(n, dtype=torch.float32, device=dev)[None],
                     torch.zeros(2, n, device=dev)])
    return torch.nn.functional.pad(geo, (0, B - n)).contiguous()


def beam_zbuffer_probe_plain(proj: PolarProjection, geoT: torch.Tensor,
                             max_shift: int = MAX_SHIFT) -> torch.Tensor:
    """Plain PyTorch version of ``beam_zbuffer_probe``."""
    f = bk.moving_fields(tuple(geoT[k] for k in range(5)), torch.zeros(3, device=geoT.device),
                         proj)
    smin, svals, s_ok = bk.beam_zbuffer_by_shifts(
        torch.stack([f["px"], f["py"], geoT[5]]), f["d"], f["col_i"], f["okp"], max_shift)
    return torch.cat([smin[None], svals, s_ok.to(torch.float32)[None],
                      torch.zeros(3, geoT.shape[1], device=geoT.device)])


def tie_counts(proj: PolarProjection, geoT: torch.Tensor, max_shift: int = MAX_SHIFT) -> set:
    """How many lanes tie at the closest depth of each beam that a lane
    reaches, counting only lanes within the band: a set of counts, {1}
    where no two lanes tie."""
    B = geoT.shape[1]
    f = bk.moving_fields(tuple(geoT[k] for k in range(5)), torch.zeros(3, device=geoT.device),
                         proj)
    smin, _, s_ok = bk.beam_zbuffer_by_shifts(geoT[5:6], f["d"], f["col_i"], f["okp"],
                                              max_shift)
    col = f["col_i"].clamp(0, B - 1)
    lane = torch.arange(B, device=geoT.device)
    at_min = (f["okp"] & ((f["col_i"] - lane).abs() <= max_shift) & s_ok[col]
              & (f["d"] == smin[col]))
    counts = torch.bincount(col[at_min], minlength=B)
    return set(counts[counts > 0].tolist())


def beam_zbuffer_probe(proj: PolarProjection, geoT: torch.Tensor,
                       max_shift: int = MAX_SHIFT) -> torch.Tensor:
    """geoT [8, B] -> [8, B] (layouts in the module docstring). CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    global launches
    if not _cuda.on_card(geoT):
        return beam_zbuffer_probe_plain(proj, geoT, max_shift)
    B = cols_padded(proj)
    _cuda.check_tensor("geoT", geoT, (8, B), geoT.device)
    if B > 1024:
        raise ValueError(f"{proj.cols} beams: the kernel holds at most 1024")
    out = torch.empty(8, B, dtype=torch.float32, device=geoT.device)
    BEAM_ZBUFFER(geoT.device, geoT.data_ptr(), out.data_ptr(), B, proj.cols, proj.f, proj.c,
                 proj.range_min, proj.range_max, int(max_shift))
    launches += 1
    return out


def empty_launch(proj: PolarProjection, device=None) -> None:
    """One launch of an empty kernel at the probe's launch shape (one block
    of B threads, the same shared memory; not counted in ``launches``): the
    floor under its device time."""
    BEAM_ZBUFFER_FLOOR(torch.device(device or "cuda"), cols_padded(proj))
