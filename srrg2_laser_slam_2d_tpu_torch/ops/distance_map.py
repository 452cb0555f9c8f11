"""Grid nearest-neighbour fields by jump flooding. Counterpart of
``srrg2_laser_slam_2d_tpu/ops/distance_map.py``: the reference's
``PathMatrix`` + ``PathMatrixDistanceSearch`` (used by
``CorrespondenceFinderNN2D``): rasterize the fixed cloud into a grid, fill
every cell with its nearest fixed point, answer nearest-point queries in
O(1) a lookup.

The field is computed with the Jump Flooding Algorithm: O(log N) passes
over the whole grid, each a shifted argmin over the eight neighbours. The
passes, their order, the border rule and the strict ``<`` are the JAX
package's, so the nearest-index field is EQUAL to it, not merely close.
Every function takes leading batch dimensions (one field per fixed cloud).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.cloud import Cloud

_INF = 3.0e38
_NO_POINT = 2**31 - 1


class NearestField(NamedTuple):
    """Per-cell nearest fixed point.

    idx:        [..., H, W] int64 index into the fixed cloud (-1 = none)
    dist2:      [..., H, W] squared distance in METERS from the cell centre
    origin:     [..., 2] world coordinates of cell (0, 0)'s corner
    resolution: [] meters per cell (float32)
    """

    idx: torch.Tensor
    dist2: torch.Tensor
    origin: torch.Tensor
    resolution: torch.Tensor


def build(fixed: Cloud, rows: int, cols: int, resolution: float,
          origin: torch.Tensor | None = None) -> NearestField:
    """Rasterize ``fixed`` ([..., N] clouds) and jump-flood the nearest-point
    field. ``origin`` defaults to the valid points' bounding-box minimum
    less one cell (grid SIZE static, PLACEMENT following the data)."""
    xy, valid = fixed.xy, fixed.valid
    batch, n = xy.shape[:-2], xy.shape[-2]
    dev = xy.device
    if origin is None:
        xy_min = torch.where(valid[..., None], xy, torch.full_like(xy, 1e30)).amin(-2)
        origin = xy_min - resolution
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev).expand(batch + (2,))

    # rasterize: the lowest point index wins a cell
    ij = torch.floor((xy - origin[..., None, :]) / resolution).to(torch.int64)
    ok = (valid & (ij[..., 0] >= 0) & (ij[..., 0] < cols)
          & (ij[..., 1] >= 0) & (ij[..., 1] < rows))
    cells = rows * cols
    flat = torch.where(ok, ij[..., 1] * cols + ij[..., 0], torch.full_like(ij[..., 0], cells))
    b = flat.reshape(-1, n).shape[0]
    offset = (torch.arange(b, device=dev) * (cells + 1))[:, None]
    src = torch.where(ok, torch.arange(n, device=dev), torch.full_like(flat, _NO_POINT))
    seed = torch.full((b * (cells + 1),), _NO_POINT, dtype=torch.int64, device=dev)
    seed = seed.scatter_reduce(0, (flat.reshape(b, n) + offset).reshape(-1),
                               src.reshape(-1), "amin")
    seed = seed.reshape(b, cells + 1)[:, :cells]
    idx = torch.where(seed == _NO_POINT, -1, seed).reshape(batch + (rows, cols))

    # cell-centre world coordinates
    gx = origin[..., 0, None] + (torch.arange(cols, dtype=torch.float32, device=dev) + 0.5) \
        * resolution
    gy = origin[..., 1, None] + (torch.arange(rows, dtype=torch.float32, device=dev) + 0.5) \
        * resolution
    cx, cy = gx[..., None, :], gy[..., :, None]
    px_all, py_all = xy[..., 0].reshape(b, n), xy[..., 1].reshape(b, n)

    def dist2_of(cand):
        has = cand >= 0
        safe = torch.clamp(cand, min=0).reshape(b, -1)
        px = torch.gather(px_all, 1, safe).reshape(cand.shape)
        py = torch.gather(py_all, 1, safe).reshape(cand.shape)
        px = torch.where(has, px, torch.full_like(px, _INF))
        py = torch.where(has, py, torch.full_like(py, _INF))
        d = (px - cx) ** 2 + (py - cy) ** 2
        return torch.where(has, d, torch.full_like(d, _INF))

    best = dist2_of(idx)
    # jump flooding: steps N/2, N/4, ..., 1, and one more pass of 1
    steps = []
    s = max(rows, cols) // 2
    while s >= 1:
        steps.append(s)
        s //= 2
    steps.append(1)
    for s in steps:
        for dy in (-s, 0, s):
            for dx in (-s, 0, s):
                if dx == 0 and dy == 0:
                    continue
                cand = torch.roll(idx, (dy, dx), dims=(-2, -1))
                # cells rolled across the border are invalid
                if dy > 0:
                    cand[..., :dy, :] = -1
                elif dy < 0:
                    cand[..., dy:, :] = -1
                if dx > 0:
                    cand[..., :, :dx] = -1
                elif dx < 0:
                    cand[..., :, dx:] = -1
                d = dist2_of(cand)
                take = d < best
                idx = torch.where(take, cand, idx)
                best = torch.where(take, d, best)
    return NearestField(idx=idx, dist2=best, origin=origin,
                        resolution=torch.tensor(resolution, dtype=torch.float32, device=dev))


def lookup(field: NearestField, queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest fixed index and squared distance for query points
    [..., Q, 2] (the field's batch dimensions leading). Queries outside the
    grid return (-1, 3e38), the reference's ``parent_map.inside()`` gate."""
    rows, cols = field.idx.shape[-2:]
    ij = torch.floor((queries - field.origin[..., None, :]) / field.resolution).to(torch.int64)
    inside = (ij[..., 0] >= 0) & (ij[..., 0] < cols) & (ij[..., 1] >= 0) & (ij[..., 1] < rows)
    flat = torch.clamp(ij[..., 1], 0, rows - 1) * cols + torch.clamp(ij[..., 0], 0, cols - 1)
    idx = torch.gather(field.idx.flatten(-2), -1, flat)
    d2 = torch.gather(field.dist2.flatten(-2), -1, flat)
    return (torch.where(inside, idx, torch.full_like(idx, -1)),
            torch.where(inside, d2, torch.full_like(d2, _INF)))
