"""Polar projection: point clouds to per-beam z-buffer canvases and back.

Counterpart of ``srrg2_laser_slam_2d_tpu/ops/projector.py``: beam =
floor(atan2(y, x) * f + c), range gates, the closest depth wins each beam
and the lowest index wins ties. ``project_local`` has three z-buffer
backends (``ZBUFFER_BACKEND``): "scatter" (two scatter-min passes, the
reference formulation), "sort" (one keyed sort) and "kernel" (the CUDA
kernel of ``ops/projector_kernel.py``). Every function accepts leading
batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import geometry
from ..utils.cloud import Cloud

_BIG = 3.0e38
_INT_MAX = 2**31 - 1


class PolarProjection(NamedTuple):
    """Projector intrinsics: column = f * angle + c over ``cols`` beams."""

    cols: int
    angle_min: float
    angle_max: float
    range_min: float
    range_max: float
    f: float
    c: float

    @staticmethod
    def make(cols: int, angle_min: float, angle_max: float,
             range_min: float = 0.0, range_max: float = 1000.0,
             f: float | None = None, c: float | None = None) -> "PolarProjection":
        if f is None:
            f = cols / (angle_max - angle_min)
        if c is None:
            c = cols / 2.0
        return PolarProjection(cols, angle_min, angle_max, range_min, range_max, f, c)


class Canvas(NamedTuple):
    """depth [..., cols] (3e38 where empty), idx [..., cols] int64 source
    index (-1 where empty), valid [..., cols] bool."""

    depth: torch.Tensor
    idx: torch.Tensor
    valid: torch.Tensor


def beam_angles(proj: PolarProjection, device=None) -> torch.Tensor:
    i = torch.arange(proj.cols, dtype=torch.float32, device=device)
    return (i - proj.c) / proj.f


def project(proj: PolarProjection, camera_pose: torch.Tensor,
            cloud: Cloud) -> tuple[Canvas, Cloud]:
    """Project ``cloud`` seen from ``camera_pose`` (sensor-in-world);
    returns the canvas and the cloud in the sensor frame."""
    inv = geometry.inverse(camera_pose)
    local = Cloud(
        xy=geometry.transform_points(inv, cloud.xy),
        normal=geometry.rotate_vectors(inv, cloud.normal),
        valid=cloud.valid,
    )
    return project_local(proj, local), local


# Backend of ``project_local``: "scatter" | "sort" | "kernel" | None. None
# picks "scatter" on the CPU and on the card alike. (The JAX package picks
# "sort" on a TPU, where a scatter with repeated indices runs as a serial
# loop; on the card ``scatter_reduce`` is a pass of atomics and keeps exact
# depths, while the kernel, one launch for a whole batch, assigns beams with
# the polynomial arctangent, so the parity route keeps "scatter" unless asked.)
ZBUFFER_BACKEND: str | None = None


def _zbuffer_backend() -> str:
    backend = "scatter" if ZBUFFER_BACKEND is None else ZBUFFER_BACKEND
    if backend not in ("scatter", "sort", "kernel"):
        raise ValueError(f"unknown z-buffer backend {backend!r}")
    return backend


def project_local(proj: PolarProjection, local: Cloud) -> Canvas:
    """Project a cloud already expressed in the sensor frame."""
    backend = _zbuffer_backend()
    if backend == "sort":
        return project_local_sort(proj, local)
    if backend == "kernel":
        from . import projector_kernel

        return projector_kernel.project_local(proj, local.xy, local.valid)
    return project_local_scatter(proj, local)


def _beam_of(proj: PolarProjection, local: Cloud):
    x, y = local.xy[..., 0], local.xy[..., 1]
    depth = torch.sqrt(x * x + y * y)
    col = torch.floor(torch.atan2(y, x) * proj.f + proj.c).to(torch.int64)
    ok = (local.valid & (col >= 0) & (col < proj.cols)
          & (depth >= proj.range_min) & (depth <= proj.range_max))
    return depth, col, ok


def project_local_sort(proj: PolarProjection, local: Cloud) -> Canvas:
    """Sort-based z-buffer: points keyed by (beam, depth quantised to 2^21
    steps over ``range_max``), one stable sort, each beam's winner its first
    sorted entry (the lowest index among equal keys). The quantisation only
    decides between points closer than ~10 um; canvas depths are the
    winner's exact depth."""
    n = local.capacity
    dev = local.xy.device
    depth, col, ok = _beam_of(proj, local)
    dq = torch.clamp((depth * (float(2**21) / proj.range_max)).to(torch.int64), 0, 2**21 - 1)
    sentinel = 2**31 - 1
    key = torch.where(ok, col * (2**21) + dq, torch.full_like(col, sentinel))
    key_s, idx_s = torch.sort(key, dim=-1, stable=True)
    col_s = key_s >> 21
    first = torch.cat([torch.ones_like(col_s[..., :1], dtype=torch.bool),
                       col_s[..., 1:] != col_s[..., :-1]], dim=-1)
    winner = (key_s != sentinel) & first
    tgt = torch.where(winner, col_s, torch.full_like(col_s, proj.cols))
    batch = depth.shape[:-1]
    ibuf = torch.full(batch + (proj.cols + 1,), -1, dtype=torch.int64,
                      device=dev).scatter(-1, tgt, idx_s)[..., : proj.cols]
    dbuf = torch.full(batch + (proj.cols + 1,), _BIG, dtype=torch.float32,
                      device=dev).scatter(-1, tgt, torch.gather(depth, -1, idx_s))
    v = ibuf >= 0
    return Canvas(depth=torch.where(v, dbuf[..., : proj.cols], torch.full_like(ibuf, _BIG,
                                                                              dtype=torch.float32)),
                  idx=ibuf, valid=v)


def project_local_scatter(proj: PolarProjection, local: Cloud) -> Canvas:
    """Scatter-min z-buffer (the reference formulation)."""
    n = local.capacity
    dev = local.xy.device
    depth, col, ok = _beam_of(proj, local)
    batch = depth.shape[:-1]
    col_s = torch.where(ok, col, torch.full_like(col, proj.cols))
    d_s = torch.where(ok, depth, torch.full_like(depth, _BIG))
    zbuf = torch.full(batch + (proj.cols + 1,), _BIG, dtype=torch.float32,
                      device=dev).scatter_reduce(-1, col_s, d_s, "amin")
    zbuf = zbuf[..., : proj.cols]
    # among the points at the minimum depth of their beam the lowest index wins
    at = torch.gather(zbuf, -1, col.clamp(0, proj.cols - 1))
    hit = ok & (depth <= at)
    idx = torch.arange(n, device=dev).expand(depth.shape)
    idx_s = torch.where(hit, idx, torch.full_like(idx, _INT_MAX))
    col_h = torch.where(hit, col, torch.full_like(col, proj.cols))
    ibuf = torch.full(batch + (proj.cols + 1,), _INT_MAX, dtype=torch.int64,
                      device=dev).scatter_reduce(-1, col_h, idx_s, "amin")
    ibuf = ibuf[..., : proj.cols]
    valid = zbuf < _BIG
    return Canvas(
        depth=torch.where(valid, zbuf, torch.full_like(zbuf, _BIG)),
        idx=torch.where(valid, ibuf, torch.full_like(ibuf, -1)),
        valid=valid,
    )


def ranges_from_canvas(canvas: Canvas, empty_value: float = 0.0) -> torch.Tensor:
    return torch.where(canvas.valid, canvas.depth,
                       torch.full_like(canvas.depth, empty_value))


def unproject(proj: PolarProjection, ranges: torch.Tensor) -> Cloud:
    """Ranges [..., cols] -> sensor-frame points; valid iff the range lies
    strictly inside (range_min, range_max). Normals are zero."""
    ranges = ranges.to(torch.float32)
    a = beam_angles(proj, ranges.device)
    xy = torch.stack([ranges * torch.cos(a), ranges * torch.sin(a)], dim=-1)
    valid = ((ranges > proj.range_min) & (ranges < proj.range_max)
             & torch.isfinite(ranges))
    return Cloud(xy=xy, normal=torch.zeros_like(xy), valid=valid)
