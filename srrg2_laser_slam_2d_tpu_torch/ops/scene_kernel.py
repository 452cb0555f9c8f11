"""Scene-sized z-buffer canvas as one kernel, and the projective clip and
merge built on it. Counterpart of
``srrg2_laser_slam_2d_tpu/ops/pallas_scene.py`` (``canvas_pallas``,
``clip_projective_pallas``, ``merge_projective_pallas``).

``canvas`` z-buffers a whole scene seen from a camera pose: per beam the
closest depth, the winner's point and normal in the camera frame and the
winner's scene row. The scene is read in chunks of ``chunk`` rows: points
tied at the minimum depth inside the winning chunk are averaged, an earlier
chunk keeps a beam against an equal depth, and the winner row is the lowest
index. The CUDA kernel is ``csrc/scene_kernel.cu`` (a thread-block cluster
of ``cluster_blocks(N)`` blocks, each row's camera-frame fields computed
once, int64 rows written by the kernel); ``canvas_plain`` is its plain
PyTorch version (a dense [chunk, B] compare per chunk). The merge's
per-beam decisions and row writes are plain PyTorch on both routes, as they
are XLA code in the JAX package.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from ..utils import geometry
from ..utils.cloud import Cloud
from . import _beam_kernels as bk
from . import _cuda
from .merge import _append_tail, _beam_decisions, _put_rows, _unit_mean
from .projector import PolarProjection
from .projector_kernel import cluster_blocks, cols_padded

_BIG = 1.0e30
# floating-point operations per scene row: 14 for the camera transform of
# point and normal, 37 for the beam assignment, 9 for the tie average
FLOPS_PER_POINT = 60
# launches of the CUDA kernel (reset by callers that count a run)
launches = 0
# calls that launched the kernel, by (scene rows, canvases)
calls: Counter = Counter()


class _SceneParams(ctypes.Structure):
    """Mirror of ``SceneParams`` in csrc/scene_kernel.cu."""

    _fields_ = [("n", ctypes.c_int), ("B", ctypes.c_int), ("cols", ctypes.c_int),
                ("chunk", ctypes.c_int), ("f", ctypes.c_float), ("c", ctypes.c_float),
                ("range_min", ctypes.c_float), ("range_max", ctypes.c_float),
                ("cluster", ctypes.c_int)]


# xy, normal, valid, camera, out, rows, params, stream
SCENE_CANVAS = _cuda.Entry("scene_kernel", "scene_canvas", [_cuda.PTR] * 8)


def _effective_chunk(n: int, chunk: int) -> int:
    """The chunk length the scan uses: ``chunk`` rows, or the whole cloud
    rounded up to it when the cloud is shorter."""
    return min(chunk, ((n + chunk - 1) // chunk) * chunk)


def canvas_plain(proj: PolarProjection, cloud: Cloud, camera_pose: torch.Tensor,
                 chunk: int = 1024):
    """Plain PyTorch version of ``canvas``."""
    n = cloud.capacity
    B = cols_padded(proj)
    dev = cloud.xy.device
    cam = camera_pose.to(torch.float32)
    cc, cs = torch.cos(cam[2]), torch.sin(cam[2])
    step = _effective_chunk(n, chunk)
    bd = torch.full((B,), _BIG, device=dev)
    fields = torch.zeros(4, B, device=dev)
    brow = torch.full((B,), -1, dtype=torch.int64, device=dev)
    for k in range(0, n, step):
        sl = slice(k, min(k + step, n))
        wx = cloud.xy[sl, 0] - cam[0]
        wy = cloud.xy[sl, 1] - cam[1]
        x = cc * wx + cs * wy
        y = -cs * wx + cc * wy
        nx = cc * cloud.normal[sl, 0] + cs * cloud.normal[sl, 1]
        ny = -cs * cloud.normal[sl, 0] + cc * cloud.normal[sl, 1]
        d, colf, ok = bk.beam_fields(x, y, cloud.valid[sl], proj)
        cmin, hot, dm = bk.tied_min_onehot(d, colf, ok, B)
        crow = dm.argmin(dim=0) + k            # the first (lowest) row at the minimum
        take = cmin < bd
        bd = torch.where(take, cmin, bd)
        fields = torch.where(take, torch.stack([x @ hot, y @ hot, nx @ hot, ny @ hot]), fields)
        brow = torch.where(take, crow, brow)
    has = bd < _BIG
    out = torch.cat([bd[None], fields, has.to(torch.float32)[None]])
    return out, torch.where(has, brow, torch.full_like(brow, -1))


def canvas(proj: PolarProjection, cloud: Cloud, camera_pose: torch.Tensor,
           chunk: int = 1024):
    """Z-buffer canvas of ``cloud`` seen from ``camera_pose`` [3]: returns
    (out [6, B] rows depth, x, y, nx, ny, has; rows [B] int64 winner row,
    -1 where empty), B the beam count padded to 128. CUDA tensors launch
    the kernel; CPU tensors take the plain version."""
    global launches
    if not _cuda.on_card(cloud.xy):
        return canvas_plain(proj, cloud, camera_pose, chunk)
    dev = cloud.xy.device
    xy, nm, valid = _cuda.cloud_tensors("cloud", cloud.xy, cloud.normal, cloud.valid, dev)
    cam = camera_pose.to(torch.float32).contiguous()
    _cuda.check_tensor("camera_pose", cam, (3,), dev)
    B = cols_padded(proj)
    if B > 1024:
        raise ValueError(f"{proj.cols} beams: the kernel holds at most 1024")
    n = xy.shape[0]
    out = torch.empty(6, B, dtype=torch.float32, device=dev)
    rows = torch.empty(B, dtype=torch.int64, device=dev)
    params = _SceneParams(n=n, B=B, cols=proj.cols, chunk=_effective_chunk(n, chunk),
                          f=proj.f, c=proj.c, range_min=proj.range_min,
                          range_max=proj.range_max, cluster=cluster_blocks(n))
    SCENE_CANVAS(dev, xy.data_ptr(), nm.data_ptr(), valid.data_ptr(), cam.data_ptr(),
                 out.data_ptr(), rows.data_ptr(), ctypes.addressof(params))
    launches += 1
    calls[(n, 1)] += 1
    return out, rows


def _cells(c: torch.Tensor):
    """Canvas rows -> ([B, 2] points, [B, 2] normals)."""
    return torch.stack([c[1], c[2]], dim=1), torch.stack([c[3], c[4]], dim=1)


def merge_projective(proj: PolarProjection, scene: Cloud, measurement: Cloud,
                     measurement_in_scene: torch.Tensor, merge_threshold: float = 0.2,
                     chunk: int = 1024, return_canvas: bool = False):
    """Fuse ``measurement`` (its own sensor frame) into ``scene`` through
    two canvases (the scene from the measurement's pose, the measurement
    from the identity): per beam merge (depths within ``merge_threshold``:
    average), replace (the measurement lies behind the scene cell) or append
    into the free tail of the compact scene. With ``return_canvas`` also the
    post-merge visible cell per padded beam in the camera frame."""
    cam = measurement_in_scene.to(torch.float32)
    s_canvas, s_rows = canvas(proj, scene, cam, chunk)
    m_canvas, _ = canvas(proj, measurement, torch.zeros(3, device=cam.device), chunk)
    sd, md = s_canvas[0], m_canvas[0]
    s_has = s_canvas[5] > 0
    m_has = (m_canvas[5] > 0) & (md <= 0.9 * proj.range_max)
    m_loc, m_loc_n = _cells(m_canvas)
    s_loc, s_loc_n = _cells(s_canvas)
    mp = geometry.transform_points(cam, m_loc)
    mn = geometry.rotate_vectors(cam, m_loc_n)

    do_merge, do_replace, do_append = _beam_decisions(md, m_has, sd, s_has, merge_threshold)
    modify = do_merge | do_replace

    n = scene.capacity
    rows = torch.where(modify, s_rows, torch.full_like(s_rows, n))   # unique per beam
    sp = geometry.transform_points(cam, s_loc)
    sn = geometry.rotate_vectors(cam, s_loc_n)
    xy = _put_rows(scene.xy, rows, torch.where(do_merge[:, None], 0.5 * (sp + mp), mp))
    nm = _put_rows(scene.normal, rows, torch.where(do_merge[:, None], _unit_mean(sn, mn), mn))
    xy, nm, valid, _, _ = _append_tail(xy, nm, scene.valid, do_append, mp, mn)
    new_scene = Cloud(xy, nm, valid)
    if not return_canvas:
        return new_scene
    cell_p = torch.where(do_merge[:, None], 0.5 * (s_loc + m_loc),
                         torch.where(m_has[:, None], m_loc, s_loc))
    cell_n = torch.where(do_merge[:, None], _unit_mean(s_loc_n, m_loc_n),
                         torch.where(m_has[:, None], m_loc_n, s_loc_n))
    return new_scene, Cloud(cell_p, cell_n, m_has | s_has)


def clip_projective(proj: PolarProjection, scene: Cloud, robot_in_local_map: torch.Tensor,
                    sensor_in_robot: torch.Tensor, chunk: int = 1024) -> Cloud:
    """The sensor-visible cell of every beam of ``scene``, in the ROBOT
    frame; one row per PADDED beam (rows past ``proj.cols`` are invalid)."""
    cam = geometry.compose(robot_in_local_map, sensor_in_robot)
    c, _ = canvas(proj, scene, cam, chunk)
    p, nrm = _cells(c)
    return Cloud(geometry.transform_points(sensor_in_robot, p),
                 geometry.rotate_vectors(sensor_in_robot, nrm), c[5] > 0)
