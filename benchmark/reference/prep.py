"""A frozen copy of the port's scan preparation, as plain PyTorch: the
polar projection and its scatter z-buffer, unprojection, sliding-window
normals, sequential voxel decimation, cloud compaction, the pre-z-buffered
measurement canvas and the tracker's seed state (``ops/projector.py``,
``ops/normals.py``, ``utils/cloud.py``, ``utils/geometry.py`` and
``models/fast_tracker.py`` of the port as the benchmark was written).

The traffic generators make their scans with it, and the references
recompute every state they compare from it. Floating tensors take the
default dtype (``_f()``), so the control runs the same steps in bfloat16.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_BIG = 3.0e38
_INT_MAX = 2**31 - 1


def _f() -> torch.dtype:
    return torch.get_default_dtype()


class PolarProjection(NamedTuple):
    """Column = f * angle + c over ``cols`` beams."""

    cols: int
    angle_min: float
    angle_max: float
    range_min: float
    range_max: float
    f: float
    c: float

    @staticmethod
    def make(cols: int, angle_min: float, angle_max: float, range_min: float = 0.0,
             range_max: float = 1000.0) -> "PolarProjection":
        return PolarProjection(cols, angle_min, angle_max, range_min, range_max,
                               cols / (angle_max - angle_min), cols / 2.0)


class Cloud(NamedTuple):
    """xy [..., N, 2], normal [..., N, 2], valid [..., N] bool."""

    xy: torch.Tensor
    normal: torch.Tensor
    valid: torch.Tensor

    def map(self, fn) -> "Cloud":
        return Cloud(fn(self.xy), fn(self.normal), fn(self.valid))


# ------------------------------------------------------------------ SE(2)

def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """T(a) T(b) on [..., 3] pose vectors, the angle wrapped."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack([a[..., 0] + c * b[..., 0] - s * b[..., 1],
                        a[..., 1] + s * b[..., 0] + c * b[..., 1],
                        wrap_angle(a[..., 2] + b[..., 2])], dim=-1)


def inverse(a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack([-(c * a[..., 0] + s * a[..., 1]),
                        -(-s * a[..., 0] + c * a[..., 1]), -a[..., 2]], dim=-1)


def transform_points(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([c * x - s * y + pose[..., 0, None],
                        s * x + c * y + pose[..., 1, None]], dim=-1)


def rotate_vectors(pose: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    x, y = vecs[..., 0], vecs[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def transform(cloud: Cloud, pose: torch.Tensor) -> Cloud:
    return Cloud(transform_points(pose, cloud.xy), rotate_vectors(pose, cloud.normal),
                 cloud.valid)


# ---------------------------------------------------------- projection

def project_local(proj: PolarProjection, local: Cloud):
    """Scatter-min z-buffer of sensor-frame points: per beam the closest
    depth, the lowest index among ties -> (depth, idx (-1 empty), valid)."""
    n = local.xy.shape[-2]
    dev = local.xy.device
    x, y = local.xy[..., 0], local.xy[..., 1]
    depth = torch.sqrt(x * x + y * y)
    col = torch.floor(torch.atan2(y, x) * proj.f + proj.c).to(torch.int64)
    ok = (local.valid & (col >= 0) & (col < proj.cols)
          & (depth >= proj.range_min) & (depth <= proj.range_max))
    batch = depth.shape[:-1]
    col_s = torch.where(ok, col, torch.full_like(col, proj.cols))
    d_s = torch.where(ok, depth, torch.full_like(depth, _BIG))
    zbuf = torch.full(batch + (proj.cols + 1,), _BIG, device=dev).scatter_reduce(
        -1, col_s, d_s, "amin")[..., : proj.cols]
    at = torch.gather(zbuf, -1, col.clamp(0, proj.cols - 1))
    hit = ok & (depth <= at)
    idx = torch.arange(n, device=dev).expand(depth.shape)
    idx_s = torch.where(hit, idx, torch.full_like(idx, _INT_MAX))
    col_h = torch.where(hit, col, torch.full_like(col, proj.cols))
    ibuf = torch.full(batch + (proj.cols + 1,), _INT_MAX, dtype=torch.int64,
                      device=dev).scatter_reduce(-1, col_h, idx_s, "amin")[..., : proj.cols]
    valid = zbuf < _BIG
    return (torch.where(valid, zbuf, torch.full_like(zbuf, _BIG)),
            torch.where(valid, ibuf, torch.full_like(ibuf, -1)), valid)


def project(proj: PolarProjection, camera_pose: torch.Tensor, cloud: Cloud):
    """``cloud`` seen from ``camera_pose`` -> (z-buffer, sensor-frame cloud)."""
    inv = inverse(camera_pose)
    local = Cloud(transform_points(inv, cloud.xy), rotate_vectors(inv, cloud.normal),
                  cloud.valid)
    return project_local(proj, local), local


def unproject(proj: PolarProjection, ranges: torch.Tensor) -> Cloud:
    """Ranges [..., cols] -> sensor-frame points, valid strictly inside the
    range gates."""
    ranges = ranges.to(_f())
    a = (torch.arange(proj.cols, device=ranges.device) - proj.c) / proj.f
    xy = torch.stack([ranges * torch.cos(a), ranges * torch.sin(a)], dim=-1)
    valid = (ranges > proj.range_min) & (ranges < proj.range_max) & torch.isfinite(ranges)
    return Cloud(xy, torch.zeros_like(xy), valid)


# ---------------------------------------------------------- preprocessing

def compute_normals(cloud: Cloud, normal_point_distance: float, normal_min_points: int,
                    window: int) -> Cloud:
    """1D sliding-window line fits over scan-ordered points, turned to face
    the sensor; points with too few neighbours lose their validity."""
    n = cloud.xy.shape[-2]
    xy, valid = cloud.xy, cloud.valid
    d2_max = normal_point_distance * normal_point_distance
    pad_xy = torch.nn.functional.pad(xy, (0, 0, window, window))
    pad_valid = torch.nn.functional.pad(valid, (window, window))
    s_w = valid.to(_f())
    s_x = torch.where(valid[..., None], xy, 0.0)
    s_xx = torch.where(valid[..., None], xy * xy, 0.0)
    s_xy = torch.where(valid, xy[..., 0] * xy[..., 1], 0.0)
    for sign in (-1, 1):
        alive = valid
        for k in range(1, window + 1):
            lo = window + sign * k
            nb_xy = pad_xy[..., lo: lo + n, :]
            nb_valid = pad_valid[..., lo: lo + n]
            d = nb_xy - xy
            d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
            alive = alive & nb_valid & (d2 <= d2_max)
            w = alive.to(_f())
            s_w = s_w + w
            s_x = s_x + w[..., None] * nb_xy
            s_xx = s_xx + w[..., None] * nb_xy * nb_xy
            s_xy = s_xy + w * nb_xy[..., 0] * nb_xy[..., 1]
    cnt = s_w
    inv = 1.0 / torch.clamp(cnt, min=1.0)
    mean = s_x * inv[..., None]
    cov_xx = s_xx[..., 0] * inv - mean[..., 0] * mean[..., 0]
    cov_yy = s_xx[..., 1] * inv - mean[..., 1] * mean[..., 1]
    cov_xy = s_xy * inv - mean[..., 0] * mean[..., 1]
    tr = cov_xx + cov_yy
    det_half = torch.sqrt(torch.clamp(
        (cov_xx - cov_yy) * (cov_xx - cov_yy) / 4.0 + cov_xy * cov_xy, min=0.0))
    lam_min = tr / 2.0 - det_half
    v1 = torch.stack([cov_xy, lam_min - cov_xx], dim=-1)
    v2 = torch.stack([lam_min - cov_yy, cov_xy], dim=-1)
    n1 = v1[..., 0] * v1[..., 0] + v1[..., 1] * v1[..., 1]
    n2 = v2[..., 0] * v2[..., 0] + v2[..., 1] * v2[..., 1]
    v = torch.where((n1 >= n2)[..., None], v1, v2)
    norm = torch.sqrt(v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2])
    degenerate = norm[..., 0] < 1e-12
    perp = torch.stack([-cov_xy, cov_xx], dim=-1)
    perp_n = torch.sqrt(perp[..., 0:1] * perp[..., 0:1] + perp[..., 1:2] * perp[..., 1:2])
    v = torch.where(degenerate[..., None], perp / torch.clamp(perp_n, min=1e-20),
                    v / torch.clamp(norm, min=1e-20))
    flip = (v[..., 0] * xy[..., 0] + v[..., 1] * xy[..., 1]) > 0
    v = torch.where(flip[..., None], -v, v)
    ok = cnt >= normal_min_points
    return Cloud(cloud.xy, torch.where(ok[..., None], v, 0.0), cloud.valid & ok)


def _normalize_mean_normals(mean_nm: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.norm(mean_nm, dim=-1, keepdim=True)
    return torch.where(norm > 1e-12, mean_nm / torch.clamp(norm, min=1e-12), mean_nm)


def voxelize_sequential(cloud: Cloud, res_xy: float, res_normal: float = 1.0) -> Cloud:
    """Consecutive points in one 4D (x, y, nx, ny) cell are averaged into
    the run's last row (masked, not compacted)."""
    n = cloud.xy.shape[-2]
    dev = cloud.xy.device
    inv, inv_n = 1.0 / res_xy, 1.0 / res_normal
    cx = torch.floor(cloud.xy[..., 0] * inv).to(torch.int32)
    cy = torch.floor(cloud.xy[..., 1] * inv).to(torch.int32)
    cnx = torch.floor(cloud.normal[..., 0] * inv_n).to(torch.int32)
    cny = torch.floor(cloud.normal[..., 1] * inv_n).to(torch.int32)
    v = cloud.valid
    same = ((cx[..., 1:] == cx[..., :-1]) & (cy[..., 1:] == cy[..., :-1])
            & (cnx[..., 1:] == cnx[..., :-1]) & (cny[..., 1:] == cny[..., :-1])
            & v[..., 1:] & v[..., :-1])
    edge = torch.ones(v.shape[:-1] + (1,), dtype=torch.bool, device=dev)
    start = torch.cat([edge, ~same], dim=-1)
    last = torch.cat([~same, edge], dim=-1)
    ones = v.to(_f())[..., None]
    vals = torch.cat([cloud.xy * ones, cloud.normal * ones, ones], dim=-1)
    pref = torch.cumsum(vals, dim=-2)
    base_at_start = pref - vals
    idx = torch.arange(n, device=dev).expand(v.shape)
    ff = torch.cummax(torch.where(start, idx, torch.full_like(idx, -1)), dim=-1).values
    totals = pref - torch.gather(base_at_start, -2, ff[..., None].expand(vals.shape))
    cntr = torch.clamp(totals[..., 4:5], min=1.0)
    return Cloud(totals[..., 0:2] / cntr, _normalize_mean_normals(totals[..., 2:4] / cntr),
                 last & v)


def preprocess(proj: PolarProjection, pre: dict, ranges: torch.Tensor) -> Cloud:
    """ranges [..., cols] -> point-normal clouds (sequential voxels)."""
    if pre.get("voxelize_mode") != "sequential":
        raise ValueError("the benchmark's preprocessing copy has the sequential voxels only")
    cloud = compute_normals(unproject(proj, ranges), pre["normal_point_distance"],
                            pre["normal_min_points"], pre["normal_window"])
    return voxelize_sequential(cloud, pre["voxelize_resolution"], 1.0)


def _scatter_rows(values: torch.Tensor, dest: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(values.shape[:-2] + (n + 1, values.shape[-1]),
                      dtype=values.dtype, device=values.device)
    return out.scatter(-2, dest[..., None].expand(values.shape), values)[..., :n, :]


def compact(cloud: Cloud) -> Cloud:
    """Valid points to the front, in order."""
    n = cloud.xy.shape[-2]
    slot = torch.cumsum(cloud.valid.to(torch.int64), dim=-1) - 1
    dest = torch.where(cloud.valid, slot, torch.full_like(slot, n))
    count = cloud.valid.sum(dim=-1, keepdim=True)
    valid = torch.arange(n, device=cloud.xy.device) < count
    return Cloud(_scatter_rows(cloud.xy, dest, n), _scatter_rows(cloud.normal, dest, n), valid)


def repad(cloud: Cloud, capacity: int) -> Cloud:
    """Compact and pad (or cut) to ``capacity`` rows."""
    c = compact(cloud)
    n = c.xy.shape[-2]
    if capacity >= n:
        pad = capacity - n
        return Cloud(torch.nn.functional.pad(c.xy, (0, 0, 0, pad)),
                     torch.nn.functional.pad(c.normal, (0, 0, 0, pad)),
                     torch.nn.functional.pad(c.valid, (0, pad)))
    return Cloud(c.xy[..., :capacity, :], c.normal[..., :capacity, :], c.valid[..., :capacity])


# ------------------------------------------------- the tracker's inputs

def _take(x: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    return torch.gather(x[..., k], -1, idx)


def measurement_canvas(proj: PolarProjection, cols_padded: int, clouds: Cloud) -> torch.Tensor:
    """[..., N] clouds -> [..., 8, B] pre-z-buffered canvases: rows 0
    depth, 1 x, 2 y, 3 nx, 4 ny, 5 has; rows 6 and 7 zero."""
    depth, idx, valid = project_local(proj, clouds)
    idx = torch.clamp(idx, min=0)
    out = torch.zeros(depth.shape[:-1] + (8, cols_padded), device=depth.device)
    out[..., 0, :proj.cols] = torch.where(valid, depth, torch.zeros_like(depth))
    out[..., 1, :proj.cols] = _take(clouds.xy, idx, 0)
    out[..., 2, :proj.cols] = _take(clouds.xy, idx, 1)
    out[..., 3, :proj.cols] = _take(clouds.normal, idx, 0)
    out[..., 4, :proj.cols] = _take(clouds.normal, idx, 1)
    out[..., 5, :proj.cols] = valid.to(_f())
    return out


def seed_state(proj: PolarProjection, cols_padded: int, capacity: int, first: Cloud,
               sensor_in_robot: torch.Tensor, odom: torch.Tensor):
    """First frame of a local map for a batch of streams ([K, N] clouds,
    [3] sensor pose, [K, 3] odometry): the scene is the measurement in the
    local-map frame -> (cache [K, 8, B], pose [K, 2, 8], scene Cloud [K, cap])."""
    K = first.xy.shape[0]
    dev = first.xy.device
    X = torch.zeros(K, 3, device=dev)
    S = sensor_in_robot.to(_f()).expand(K, 3)
    XS = compose(X, S)
    scene = repad(transform(first, XS), capacity)
    (depth, idx, valid), local = project(proj, XS, scene)
    idx = torch.clamp(idx, min=0)
    cache = torch.zeros(K, 8, cols_padded, device=dev)
    cache[:, 0, :proj.cols] = _take(local.xy, idx, 0)
    cache[:, 1, :proj.cols] = _take(local.xy, idx, 1)
    cache[:, 2, :proj.cols] = _take(local.normal, idx, 0)
    cache[:, 3, :proj.cols] = _take(local.normal, idx, 1)
    cache[:, 4, :proj.cols] = valid.to(_f())
    cache[:, 5, :proj.cols] = torch.where(valid, idx, torch.full_like(idx, -1)).to(_f())
    cache[:, 5, proj.cols:] = -1.0
    pose = torch.zeros(K, 2, 8, device=dev)
    pose[:, 0, 0:3] = X
    pose[:, 0, 3:6] = odom.to(_f())
    pose[:, 0, 6] = 1.0
    pose[:, 0, 7] = scene.valid.sum(-1).to(_f())
    pose[:, 1, 0:3] = S
    return cache, pose, scene
