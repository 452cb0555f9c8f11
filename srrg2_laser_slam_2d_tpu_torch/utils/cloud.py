"""Fixed-capacity masked 2D point-normal clouds.

Counterpart of ``srrg2_laser_slam_2d_tpu/utils/cloud.py``. A ``Cloud``
always carries ``capacity`` rows; invalid rows are masked out. Every
function accepts leading batch dimensions unless noted.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry


class Cloud(NamedTuple):
    """xy [..., N, 2] float32, normal [..., N, 2] float32, valid [..., N] bool."""

    xy: torch.Tensor
    normal: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=-1)

    def map(self, fn) -> "Cloud":
        """Apply ``fn`` to each of the three fields."""
        return Cloud(fn(self.xy), fn(self.normal), fn(self.valid))

    def to(self, device) -> "Cloud":
        return self.map(lambda x: x.to(device))


def empty(capacity: int, device=None, batch: tuple = ()) -> Cloud:
    return Cloud(
        xy=torch.zeros(batch + (capacity, 2), dtype=torch.float32, device=device),
        normal=torch.zeros(batch + (capacity, 2), dtype=torch.float32, device=device),
        valid=torch.zeros(batch + (capacity,), dtype=torch.bool, device=device),
    )


def from_numpy(xy, normal=None, valid=None, capacity: int | None = None,
               device=None) -> Cloud:
    """Build a Cloud from host arrays, padding to ``capacity``."""
    xy = torch.as_tensor(xy, dtype=torch.float32, device=device)
    n = xy.shape[0]
    capacity = n if capacity is None else capacity
    normal = (torch.zeros_like(xy) if normal is None
              else torch.as_tensor(normal, dtype=torch.float32, device=device))
    valid = (torch.ones(n, dtype=torch.bool, device=device) if valid is None
             else torch.as_tensor(valid, dtype=torch.bool, device=device))
    pad = capacity - n
    if pad < 0:
        raise ValueError(f"capacity {capacity} < number of points {n}")
    if pad:
        xy = torch.nn.functional.pad(xy, (0, 0, 0, pad))
        normal = torch.nn.functional.pad(normal, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return Cloud(xy, normal, valid)


def transform(cloud: Cloud, pose: torch.Tensor) -> Cloud:
    """Rigid transform of coordinates and normals."""
    return Cloud(
        xy=geometry.transform_points(pose, cloud.xy),
        normal=geometry.rotate_vectors(pose, cloud.normal),
        valid=cloud.valid,
    )


def _scatter_rows(values: torch.Tensor, dest: torch.Tensor, n: int) -> torch.Tensor:
    """out[..., dest[k], :] = values[..., k, :] into an [..., n, 2] zero
    buffer; ``dest == n`` drops the row."""
    out = torch.zeros(values.shape[:-2] + (n + 1, values.shape[-1]),
                      dtype=values.dtype, device=values.device)
    idx = dest[..., None].expand(values.shape)
    return out.scatter(-2, idx, values)[..., :n, :]


def compact(cloud: Cloud) -> Cloud:
    """Move all valid points to the front, preserving order."""
    n = cloud.capacity
    slot = torch.cumsum(cloud.valid.to(torch.int64), dim=-1) - 1
    dest = torch.where(cloud.valid, slot, torch.full_like(slot, n))
    count = cloud.valid.sum(dim=-1, keepdim=True)
    valid = torch.arange(n, device=cloud.xy.device) < count
    return Cloud(_scatter_rows(cloud.xy, dest, n),
                 _scatter_rows(cloud.normal, dest, n), valid)


def repad(cloud: Cloud, capacity: int) -> Cloud:
    """Compact and re-pad to a new capacity (truncates overflow)."""
    c = compact(cloud)
    n = c.capacity
    if capacity == n:
        return c
    if capacity > n:
        pad = capacity - n
        return Cloud(
            xy=torch.nn.functional.pad(c.xy, (0, 0, 0, pad)),
            normal=torch.nn.functional.pad(c.normal, (0, 0, 0, pad)),
            valid=torch.nn.functional.pad(c.valid, (0, pad)),
        )
    return Cloud(c.xy[..., :capacity, :], c.normal[..., :capacity, :],
                 c.valid[..., :capacity])


def concat(a: Cloud, b: Cloud, capacity: int | None = None) -> Cloud:
    """The valid points of ``a`` then those of ``b``, compacted into
    ``capacity`` rows (default: both capacities; overflow is dropped). One
    cloud, no batch."""
    a, b = compact(a), compact(b)
    cap = a.capacity + b.capacity if capacity is None else capacity
    na, nb = a.valid.sum(), b.valid.sum()
    dev = a.xy.device
    dest = torch.cat([torch.where(a.valid, torch.arange(a.capacity, device=dev), cap),
                      torch.where(b.valid, na + torch.arange(b.capacity, device=dev), cap)])
    dest = torch.clamp(dest, max=cap)
    valid = torch.arange(cap, device=dev) < torch.clamp(na + nb, max=cap)
    return Cloud(_scatter_rows(torch.cat([a.xy, b.xy]), dest, cap),
                 _scatter_rows(torch.cat([a.normal, b.normal]), dest, cap), valid)


def stack(clouds) -> Cloud:
    """Clouds of one capacity stacked along a new leading axis (the
    cue-stacked measurement [C, N, ...] of the multi-cue tracker)."""
    return Cloud(*(torch.stack(fields) for fields in zip(*clouds)))


def clip_ball(cloud: Cloud, center: torch.Tensor, max_range: float) -> Cloud:
    """Radial clip around ``center`` [2], as a mask update."""
    d2 = ((cloud.xy - center) ** 2).sum(dim=-1)
    return Cloud(cloud.xy, cloud.normal, cloud.valid & (d2 <= max_range * max_range))


def _normalize_mean_normals(mean_nm: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.norm(mean_nm, dim=-1, keepdim=True)
    return torch.where(norm > 1e-12, mean_nm / torch.clamp(norm, min=1e-12),
                       mean_nm)


def voxelize(cloud: Cloud, res_xy: float, res_normal: float = 1.0) -> Cloud:
    """Grid voxel decimation (one cloud, no batch): average all valid points
    sharing a 4D (x, y, nx, ny) cell; output in cell order, compacted."""
    n = cloud.capacity
    dev = cloud.xy.device
    inv, inv_n = 1.0 / res_xy, 1.0 / res_normal
    cx = torch.floor(cloud.xy[:, 0] * inv).to(torch.int32)
    cy = torch.floor(cloud.xy[:, 1] * inv).to(torch.int32)
    cnx = torch.floor(cloud.normal[:, 0] * inv_n).to(torch.int32)
    cny = torch.floor(cloud.normal[:, 1] * inv_n).to(torch.int32)
    key_hi = cx * 65536 + (cy & 0xFFFF)
    key_lo = (cy >> 16) * 1024 + (cnx & 0x1F) * 32 + (cny & 0x1F)
    # lexicographic order (invalid last, then key_hi, then key_lo): stable
    # sorts from the least significant key up
    order = torch.argsort(key_lo, stable=True)
    order = order[torch.argsort(key_hi[order], stable=True)]
    order = order[torch.argsort((~cloud.valid[order]).to(torch.int8), stable=True)]
    v = cloud.valid[order]
    khi, klo = key_hi[order], key_lo[order]
    xy, nm = cloud.xy[order], cloud.normal[order]
    new_group = torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev),
        (khi[1:] != khi[:-1]) | (klo[1:] != klo[:-1]) | (v[1:] != v[:-1]),
    ]) & v
    gid = torch.cumsum(new_group.to(torch.int64), 0) - 1
    gid = torch.where(v, gid, torch.full_like(gid, n))
    ones = v.to(torch.float32)
    cnt = torch.zeros(n + 1, device=dev).index_add_(0, gid, ones)[:n]
    sum_xy = torch.zeros(n + 1, 2, device=dev).index_add_(0, gid, xy * ones[:, None])[:n]
    sum_nm = torch.zeros(n + 1, 2, device=dev).index_add_(0, gid, nm * ones[:, None])[:n]
    denom = torch.clamp(cnt, min=1.0)[:, None]
    return Cloud(sum_xy / denom, _normalize_mean_normals(sum_nm / denom), cnt > 0)


def voxelize_sequential(cloud: Cloud, res_xy: float,
                        res_normal: float = 1.0) -> Cloud:
    """Voxel decimation for scan-ordered clouds: consecutive points in the
    same 4D cell form a run, averaged into the run's LAST row (masked, not
    compacted). Batched over leading dimensions."""
    n = cloud.capacity
    dev = cloud.xy.device
    inv, inv_n = 1.0 / res_xy, 1.0 / res_normal
    cx = torch.floor(cloud.xy[..., 0] * inv).to(torch.int32)
    cy = torch.floor(cloud.xy[..., 1] * inv).to(torch.int32)
    cnx = torch.floor(cloud.normal[..., 0] * inv_n).to(torch.int32)
    cny = torch.floor(cloud.normal[..., 1] * inv_n).to(torch.int32)
    v = cloud.valid
    same = (
        (cx[..., 1:] == cx[..., :-1]) & (cy[..., 1:] == cy[..., :-1])
        & (cnx[..., 1:] == cnx[..., :-1]) & (cny[..., 1:] == cny[..., :-1])
        & v[..., 1:] & v[..., :-1]
    )
    edge = torch.ones(v.shape[:-1] + (1,), dtype=torch.bool, device=dev)
    start = torch.cat([edge, ~same], dim=-1)
    last = torch.cat([~same, edge], dim=-1)
    ones = v.to(torch.float32)[..., None]
    vals = torch.cat([cloud.xy * ones, cloud.normal * ones, ones], dim=-1)
    pref = torch.cumsum(vals, dim=-2)
    base_at_start = pref - vals
    idx = torch.arange(n, device=dev).expand(v.shape)
    ff = torch.cummax(torch.where(start, idx, torch.full_like(idx, -1)), dim=-1).values
    totals = pref - torch.gather(base_at_start, -2, ff[..., None].expand(vals.shape))
    cntr = torch.clamp(totals[..., 4:5], min=1.0)
    mean_xy = totals[..., 0:2] / cntr
    mean_nm = _normalize_mean_normals(totals[..., 2:4] / cntr)
    return Cloud(mean_xy, mean_nm, last & v)
