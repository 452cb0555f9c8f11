"""The whole tracking frame as one kernel, and a whole chunk of frames as
one launch.

Counterpart of ``srrg2_laser_slam_2d_tpu/ops/pallas_frame.py``
(``track_frames_grid`` / ``frame_step``, body ``_frame_body``). Per frame:
clip-from-cache (the carried canvas), banded projective Gauss-Newton with
an odometry prior, the lean beam-window merge, and the in-kernel local-map
split. The CUDA kernel is ``csrc/frame_kernel.cu``; ``_frame_body_plain``
below is its plain PyTorch version.

Only the pre-z-buffered measurement layout (``meas_as_canvas=True``, the
one the chunked SLAM loop uses) is ported. State and IO layouts are those
of the Pallas kernel:
  cacheT [8, B]: rows 0 x, 1 y, 2 nx, 3 ny, 4 valid, 5 scene row (-1 none).
  pose [2, 8]: row 0 = [X 0:3, last_odom 3:6, has_odom 6, scene count 7];
      row 1 = [sensor_in_robot 0:3, ...].
  measC [T, 8, B]: rows 0 depth, 1 x, 2 y, 3 nx, 4 ny, 5 has, row 6 lanes
      0-3 = [odom x, y, theta, odom_valid].
  payloads [T, 8, B]: rows 0-3 scene-frame point, 4 target row, 5 kind
      (0 none / 1 modify / 2 append), row 6 lanes 0-11 = [T'(3), chi,
      n_corr, n_inliers, n_app, split flag, X'(3), scene count], row 7
      lanes [0:its] chi and [64:64+its] inliers per GN iteration.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _beam_kernels as bk
from . import _cuda
from .projector import PolarProjection

# launches of the CUDA kernel (reset by callers that count a run)
launches = 0


@dataclass(frozen=True)
class FrameSpec:
    """Static configuration of the fused frame kernel."""

    projection: PolarProjection
    scene_capacity: int = 8192
    iterations: int = 10
    point_distance: float = 0.5
    normal_cos: float = 0.8
    chi_threshold: float = 0.05
    min_inliers: int = 10
    odom_weight: float = 1.0
    merge_threshold: float = 0.2
    merge_shift: int = 32
    window: int = 256
    meas_as_canvas: bool = True
    # in-kernel local-map split when |X'| reaches this distance (0 = off)
    split_distance: float = 0.0
    # K-stream kernel (ops/stream_kernel.py) only; this kernel ignores them.
    # Gather band: "onehot" matches a beam inside the window of the lane's
    # 128-beam block, "roll" within +-stream_band_shift beams of the lane.
    stream_gather: str = "onehot"
    stream_band_shift: int = 64
    # Gauss-Newton updates per canvas gather (1 = gather at every update)
    corr_refresh: int = 1

    @property
    def cols_padded(self) -> int:
        c = self.projection.cols
        return max(((c + 127) // 128) * 128, self.window)


def flops_per_lane_frame(iterations: int) -> int:
    """Floating-point operations per beam lane per frame, counted from the
    frame body: 14 to re-frame the cache cell, 110 per Gauss-Newton pass
    (43 for the transform and beam assignment, 54 for the match and the
    normal-equation terms, 13 for the block sums; ``iterations`` + 1
    passes) and 60 for the merge."""
    return 14 + 110 * (iterations + 1) + 60


def _check_spec(spec: FrameSpec) -> None:
    if not spec.meas_as_canvas:
        raise NotImplementedError(
            "only the pre-z-buffered [T, 8, B] measurement layout is ported")
    if spec.iterations > 64:
        raise ValueError("payload iteration row supports <= 64 iterations")


# ------------------------------------------------------------ plain version

def _frame_body_plain(spec: FrameSpec, canvasT, odomF, cacheT, pose):
    """One frame. canvasT [8, B], odomF [4] (x, y, theta, valid), cacheT
    [8, B], pose [2, 8] -> (cacheT', pose', payload [8, B])."""
    proj = spec.projection
    B = spec.cols_padded
    cap = float(spec.scene_capacity)
    dev = canvasT.device
    zero3 = torch.zeros(3, device=dev)

    X_old, last_odom = pose[0, 0:3], pose[0, 3:6]
    has_odom, count = pose[0, 6], pose[0, 7]
    S = pose[1, 0:3]
    odom, ov = odomF[0:3], odomF[3]

    use_prior = (has_odom > 0) & (ov > 0)
    D = torch.where(use_prior, bk.relative_s(last_odom, odom), zero3)
    T0 = bk.inverse_s(bk.compose_s(D, S))

    cS, sS = torch.cos(S[2]), torch.sin(S[2])
    cx, cy, cnx, cny, cval, crow = cacheT[0], cacheT[1], cacheT[2], cacheT[3], cacheT[4], cacheT[5]
    mov = (cS * cx - sS * cy + S[0], sS * cx + cS * cy + S[1],
           cS * cnx - sS * cny, sS * cnx + cS * cny, cval)

    lane = torch.arange(B, device=dev)
    iter_row = torch.zeros(B, device=dev)
    T = T0
    for i in range(spec.iterations):
        s = bk.banded_stats(canvasT, bk.moving_fields(mov, T, proj), B,
                            spec.point_distance, spec.normal_cos,
                            spec.chi_threshold, window=spec.window)
        iter_row = torch.where(lane == i, s[10], iter_row)
        iter_row = torch.where(lane == 64 + i, s[12], iter_row)
        sums9 = tuple(s[k] for k in range(9))
        if spec.odom_weight > 0:
            sums9 = bk.add_odom_prior(sums9, T, T0, spec.odom_weight)
        h00, h01, h02, h11, h12, h22, b0, b1, b2 = sums9
        dx = bk.solve3_sym(h00, h01, h02, h11, h12, h22, -b0, -b1, -b2, 1e-20)
        guard = s[9] >= spec.min_inliers
        dx = torch.stack([torch.where(guard, v, torch.zeros_like(v)) for v in dx])
        T = bk.compose_s(dx, T)

    f = bk.moving_fields(mov, T, proj)
    s = bk.banded_stats(canvasT, f, B, spec.point_distance, spec.normal_cos,
                        spec.chi_threshold, window=spec.window)

    # ---- merge (beam-window lean semantics) ----
    vals = torch.stack([f["px"], f["py"], f["nx"], f["ny"], crow])
    smin, svals, s_ok = bk.beam_zbuffer_by_shifts(
        vals, f["d"], f["col_i"], f["okp"] & (crow >= 0), spec.merge_shift)
    mg = bk.merge_lanes(canvasT, smin, svals, s_ok, count, 0.9 * proj.range_max,
                        spec.merge_threshold, cap)
    m_ok, app_ok, target, kind = mg["m_ok"], mg["app_ok"], mg["target"], mg["kind"]
    upd_px, upd_py, upd_nx, upd_ny = mg["upd"]
    ncx, ncy, nnx, nny, nvalid, nrow = mg["cache"]
    n_app = mg["do_append"].to(torch.float32).sum()

    X_new = bk.compose_s(X_old, bk.inverse_s(bk.compose_s(S, T)))
    M = bk.compose_s(X_new, S)
    cM, sM = torch.cos(M[2]), torch.sin(M[2])
    pay_x = cM * upd_px - sM * upd_py + M[0]
    pay_y = sM * upd_px + cM * upd_py + M[1]
    pay_nx = cM * upd_nx - sM * upd_ny
    pay_ny = sM * upd_nx + cM * upd_ny
    count_new = torch.clamp(count + n_app, max=cap)

    do_split = torch.zeros((), device=dev)
    if spec.split_distance > 0:
        do_split = (torch.sqrt(X_new[0] * X_new[0] + X_new[1] * X_new[1])
                     >= spec.split_distance).to(torch.float32)
        bfx, bfy, bfnx, bfny = canvasT[1], canvasT[2], canvasT[3], canvasT[4]
        seedf = m_ok.to(torch.float32)
        seed_slot = bk.lane_prefix_sum(seedf) - 1.0   # not capped (as in Pallas)
        seed_count = torch.clamp(seedf.sum(), max=cap)
        sp = do_split > 0
        pay_x = torch.where(sp, cS * bfx - sS * bfy + S[0], pay_x)
        pay_y = torch.where(sp, sS * bfx + cS * bfy + S[1], pay_y)
        pay_nx = torch.where(sp, cS * bfnx - sS * bfny, pay_nx)
        pay_ny = torch.where(sp, sS * bfnx + cS * bfny, pay_ny)
        seed_target = torch.where(m_ok, seed_slot, torch.full_like(seed_slot, -1.0))
        target = torch.where(sp, seed_target, target)
        kind = torch.where(sp, torch.where(m_ok, 2.0, 0.0), kind)
        ncx = torch.where(sp, bfx, ncx)
        ncy = torch.where(sp, bfy, ncy)
        nnx = torch.where(sp, bfnx, nnx)
        nny = torch.where(sp, bfny, nny)
        nrow = torch.where(sp, seed_target, nrow)
        nvalid = torch.where(sp, seedf, nvalid)
        count_new = torch.where(sp, seed_count, count_new)

    stats_vals = torch.cat([
        T, torch.stack([s[10], s[9], s[12], app_ok.to(torch.float32).sum(),
                        do_split]),
        X_new, count_new[None],
    ])
    stats_row = torch.zeros(B, device=dev)
    stats_row[:12] = stats_vals
    payload = torch.stack([pay_x, pay_y, pay_nx, pay_ny, target, kind,
                           stats_row, iter_row])
    zeros = torch.zeros(B, device=dev)
    cacheT_new = torch.stack([ncx, ncy, nnx, nny, nvalid, nrow, zeros, zeros])

    if spec.split_distance > 0:
        X_new = torch.where(do_split > 0, zero3, X_new)
    new_last_odom = torch.where(ov > 0, odom, last_odom)
    new_has = torch.maximum(has_odom, ov)
    row0 = torch.cat([X_new, new_last_odom, torch.stack([new_has, count_new])])
    pose_new = torch.stack([row0, pose[1]])
    return cacheT_new, pose_new, payload


def track_frames_grid_plain(spec: FrameSpec, cacheT, pose, measC):
    """Plain PyTorch version of ``track_frames_grid``: T frames in order."""
    _check_spec(spec)
    payloads = []
    for t in range(measC.shape[0]):
        cacheT, pose, pay = _frame_body_plain(spec, measC[t], measC[t, 6, 0:4],
                                              cacheT, pose)
        payloads.append(pay)
    return cacheT, pose, torch.stack(payloads)


# ------------------------------------------------------------ CUDA kernel

class _FrameParams(ctypes.Structure):
    """Mirror of ``FrameParams`` in csrc/frame_common.cuh."""

    _fields_ = [
        ("T", ctypes.c_int), ("B", ctypes.c_int), ("cols", ctypes.c_int),
        ("iterations", ctypes.c_int), ("merge_shift", ctypes.c_int),
        ("window", ctypes.c_int), ("use_prior", ctypes.c_int),
        ("use_split", ctypes.c_int),
        ("K", ctypes.c_int), ("gather_roll", ctypes.c_int),
        ("band_shift", ctypes.c_int), ("corr_refresh", ctypes.c_int),
        ("f", ctypes.c_float), ("c", ctypes.c_float),
        ("range_min", ctypes.c_float), ("range_max", ctypes.c_float),
        ("merge_range", ctypes.c_float), ("cap", ctypes.c_float),
        ("point_distance", ctypes.c_float), ("normal_cos", ctypes.c_float),
        ("chi_threshold", ctypes.c_float), ("min_inliers", ctypes.c_float),
        ("odom_weight", ctypes.c_float), ("merge_threshold", ctypes.c_float),
        ("split_distance", ctypes.c_float),
    ]


def _params(spec: FrameSpec, T: int, K: int = 1) -> _FrameParams:
    p = spec.projection
    return _FrameParams(
        T=T, B=spec.cols_padded, cols=p.cols, iterations=spec.iterations,
        merge_shift=spec.merge_shift, window=spec.window,
        use_prior=int(spec.odom_weight > 0), use_split=int(spec.split_distance > 0),
        K=K, gather_roll=int(spec.stream_gather == "roll"),
        band_shift=spec.stream_band_shift, corr_refresh=max(int(spec.corr_refresh), 1),
        f=p.f, c=p.c, range_min=p.range_min, range_max=p.range_max,
        merge_range=0.9 * p.range_max, cap=float(spec.scene_capacity),
        point_distance=spec.point_distance, normal_cos=spec.normal_cos,
        chi_threshold=spec.chi_threshold, min_inliers=float(spec.min_inliers),
        odom_weight=spec.odom_weight, merge_threshold=spec.merge_threshold,
        split_distance=spec.split_distance,
    )


def track_frames_grid(spec: FrameSpec, cacheT: torch.Tensor, pose: torch.Tensor,
                      measC: torch.Tensor):
    """Track T frames in order as ONE launch. Returns (cacheT', pose',
    payloads [T, 8, B]). CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    global launches
    _check_spec(spec)
    if measC.device.type == "cpu":
        return track_frames_grid_plain(spec, cacheT, pose, measC)
    if measC.device.type != "cuda":
        raise ValueError(f"unsupported device {measC.device}")
    B = spec.cols_padded
    T = measC.shape[0]
    dev = measC.device
    _cuda.check_tensor("measC", measC, (T, 8, B), dev)
    _cuda.check_tensor("cacheT", cacheT, (8, B), dev)
    _cuda.check_tensor("pose", pose, (2, 8), dev)
    if B > 1024 or B % 128:
        raise ValueError(f"cols_padded {B} must be a multiple of 128 and <= 1024")
    out_cache = torch.empty_like(cacheT)
    out_pose = torch.empty_like(pose)
    payloads = torch.empty((T, 8, B), dtype=torch.float32, device=dev)
    lib = _cuda.load("frame_kernel")
    params = _params(spec, T)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.frame_track_grid(
            measC.data_ptr(), cacheT.data_ptr(), pose.data_ptr(),
            out_cache.data_ptr(), out_pose.data_ptr(), payloads.data_ptr(),
            ctypes.addressof(params), stream)
    if err != 0:
        raise RuntimeError(f"frame kernel launch failed: {_cuda.error_string(err)}")
    launches += 1
    return out_cache, out_pose, payloads


def frame_step(spec: FrameSpec, measC: torch.Tensor, cacheT: torch.Tensor,
               pose: torch.Tensor):
    """One frame ([8, B] canvas): the same kernel with T = 1."""
    c, p, pay = track_frames_grid(spec, cacheT, pose, measC[None].contiguous())
    return c, p, pay[0]
