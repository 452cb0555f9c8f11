"""The fused tracking frame for K independent streams: all K streams over
all T frames as one launch. The throughput path.

Counterpart of ``srrg2_laser_slam_2d_tpu/ops/pallas_stream.py``
(``track_streams_grid`` / ``stream_step``, body ``_frame_body_b``). Per frame
and stream it is the single-stream frame kernel (``ops/frame_kernel.py``)
without the local-map split: clip-from-cache, banded projective
Gauss-Newton with an odometry prior, the lean beam-window merge. Each
stream carries its own cache canvas, pose, odometry and scene count. The
CUDA kernel is ``csrc/stream_kernel.cu`` (one persistent block per stream);
``_frame_body_b_plain`` below is its plain PyTorch version on [K, B] rows.

Two gather bands (``FrameSpec.stream_gather``): ``"onehot"`` matches a
moving lane's beam only inside the window of the lane's 128-beam block
(``bk.window_start``; at ``window=128`` the block itself), ``"roll"`` while
the beam lies within ``stream_band_shift`` beams of the lane. With
``FrameSpec.corr_refresh`` r > 1 the canvas cells gathered at an outer step
stay frozen for r Gauss-Newton updates, the moving side and every gate
being re-evaluated at each new pose.

Layouts (float32, those of the Pallas kernel):
  canvases / caches [8, K, B]: field-major. Measurement canvas rows 0 depth,
      1 x, 2 y, 3 nx, 4 ny, 5 has; cache rows 0 x, 1 y, 2 nx, 3 ny, 4 valid,
      5 scene row (-1 none).
  poseB [K, 16]: lanes 0:3 X, 3:6 last_odom, 6 has_odom, 7 scene count,
      8:11 sensor_in_robot, 11:16 zero.
  odomB [K, 8]: lanes 0:4 = odom x, y, theta, valid.
  measurements [T, 8, K, B], odometry [T, K, 8], payloads [T, 8, K, B]:
      rows 0-3 scene-frame point, 4 target row, 5 kind (0 none / 1 modify /
      2 append), row 6 lanes 0-6 = [T'(3), chi, n_corr, n_inliers, n_app],
      row 7 lanes [0:its] chi and [64:64+its] inliers per GN iteration.
The Pallas kernel also takes a stream-major copy of the measurements
(``measCk_stack`` [T, K, 8, B]); it exists only to feed the TPU's batched
matrix unit, and the port has no use for it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _beam_kernels as bk
from . import _cuda
from .frame_kernel import FrameSpec, _params
from ..utils import profiling

# launches of the CUDA kernel (reset by callers that count a run)
launches = 0


def flops_per_lane_frame(iterations: int, corr_refresh: int = 1) -> int:
    """Floating-point operations per beam lane per frame, counted from the
    frame body as for the single-stream kernel: 14 to re-frame the cache
    cell; per Gauss-Newton pass (``iterations`` + 1 of them) 43 for the
    transform and beam assignment, 50 for the gates and normal-equation
    terms and 13 for the block sums; 4 per canvas gather for the band test
    (one gather per ``corr_refresh`` updates, and one for the last pass);
    60 for the merge."""
    passes = iterations + 1
    gathers = -(-iterations // max(int(corr_refresh), 1)) + 1
    return 14 + 106 * passes + 4 * gathers + 60


def _check_spec(spec: FrameSpec) -> None:
    if spec.iterations > 64:
        raise ValueError("payload iteration row supports <= 64 iterations")
    if spec.stream_gather not in ("onehot", "roll"):
        raise ValueError(f"unknown stream_gather {spec.stream_gather!r}")


# ------------------------------------------------------------ plain version

def _pose3(block: torch.Tensor, lo: int) -> torch.Tensor:
    """Lanes lo:lo+3 of a [K, n] block as a [3, K, 1] pose, whose entries
    broadcast against [K, B] rows (what the ``bk`` SE(2) helpers index)."""
    return block[:, lo:lo + 3].t().unsqueeze(-1)


def _roll_hot(f, spec: FrameSpec):
    """The shift enumeration's band: the beam lies within
    ``stream_band_shift`` of the lane; no block window."""
    lane = torch.arange(spec.cols_padded, device=f["col_i"].device)
    return f["okp"] & (torch.abs(f["col_i"] - lane) <= spec.stream_band_shift)


def _stats_from_gather_b(gath, f, spec: FrameSpec) -> torch.Tensor:
    """Whole-row sums of the 13 terms, [13, K, 1]."""
    return bk.match_terms(gath, f, spec.point_distance, spec.normal_cos,
                          spec.chi_threshold).sum(dim=-1, keepdim=True)


def _frame_body_b_plain(spec: FrameSpec, measC, cacheB, poseB, odomB):
    """One tracking frame for K streams. measC / cacheB [8, K, B], poseB
    [K, 16], odomB [K, 8] -> (cacheB', poseB', payload [8, K, B])."""
    proj = spec.projection
    B = spec.cols_padded
    cap = float(spec.scene_capacity)
    K = poseB.shape[0]
    dev = measC.device

    X_old, last_odom, S = _pose3(poseB, 0), _pose3(poseB, 3), _pose3(poseB, 8)
    has_odom, count = poseB[:, 6:7], poseB[:, 7:8]
    odom, ov = _pose3(odomB, 0), odomB[:, 3:4]

    # odometry-predicted initial guess / prior: T0 = (D o S)^-1
    use_prior = (has_odom > 0) & (ov > 0)
    D = torch.where(use_prior, bk.relative_s(last_odom, odom), torch.zeros_like(odom))
    T0 = bk.inverse_s(bk.compose_s(D, S))

    # moving cloud = cache cells re-framed prev-sensor -> prev-robot
    cS, sS = torch.cos(S[2]), torch.sin(S[2])
    cx, cy, cnx, cny, cval, crow = cacheB[:6]
    mov = (cS * cx - sS * cy + S[0], sS * cx + cS * cy + S[1],
           cS * cnx - sS * cny, sS * cnx + cS * cny, cval)

    if spec.stream_gather == "roll":
        def gather_of(f):
            return bk.gather_canvas(measC, f, _roll_hot(f, spec))

        def stats_of(f):
            return _stats_from_gather_b(gather_of(f), f, spec)
    else:
        def gather_of(f):
            return bk.gather_canvas(measC, f, bk.window_hot(f, B, spec.window))

        def stats_of(f):
            # per-128-lane-block partials, then the lane sum (the Pallas order)
            return bk.banded_stats(measC, f, B, spec.point_distance, spec.normal_cos,
                                   spec.chi_threshold, window=spec.window).unsqueeze(-1)

    it_lane = torch.arange(B, device=dev).expand(K, B)

    def solve_update(s, T, iter_row, step):
        iter_row = torch.where(it_lane == step, s[10], iter_row)
        iter_row = torch.where(it_lane == 64 + step, s[12], iter_row)
        sums9 = tuple(s[k] for k in range(9))
        if spec.odom_weight > 0:
            sums9 = bk.add_odom_prior(sums9, T, T0, spec.odom_weight)
        h00, h01, h02, h11, h12, h22, b0, b1, b2 = sums9
        dx = bk.solve3_sym(h00, h01, h02, h11, h12, h22, -b0, -b1, -b2, 1e-20)
        guard = s[9] >= spec.min_inliers
        dx = torch.stack([torch.where(guard, v, torch.zeros_like(v)) for v in dx])
        return bk.compose_s(dx, T), iter_row

    T = T0
    iter_row = torch.zeros(K, B, device=dev)
    refresh = max(int(spec.corr_refresh), 1)
    if refresh == 1:
        for i in range(spec.iterations):
            s = stats_of(bk.moving_fields(mov, T, proj))
            T, iter_row = solve_update(s, T, iter_row, i)
    else:
        # one gather per outer step feeds `refresh` updates on frozen cells;
        # updates past `iterations` are masked in the Pallas loop, so they
        # are not run here
        for i in range(-(-spec.iterations // refresh)):
            f = bk.moving_fields(mov, T, proj)
            g = gather_of(f)
            for sub in range(refresh):
                step = i * refresh + sub
                if step >= spec.iterations:
                    break
                if sub > 0:
                    f = bk.moving_fields(mov, T, proj)
                T, iter_row = solve_update(_stats_from_gather_b(g, f, spec), T,
                                           iter_row, step)

    # final fields: stats and the transformed cache (current sensor frame)
    f = bk.moving_fields(mov, T, proj)
    s = stats_of(f)

    # ---- merge (beam-window lean semantics) ----
    vals = torch.stack([f["px"], f["py"], f["nx"], f["ny"], crow])
    smin, svals, s_ok = bk.beam_zbuffer_by_shifts(
        vals, f["d"], f["col_i"], f["okp"] & (crow >= 0), spec.merge_shift)
    # appends take scene rows on from the carried per-stream count
    mg = bk.merge_lanes(measC, smin, svals, s_ok, count, 0.9 * proj.range_max,
                        spec.merge_threshold, cap)
    upd_px, upd_py, upd_nx, upd_ny = mg["upd"]
    n_app = mg["do_append"].to(torch.float32).sum(dim=-1, keepdim=True)

    # new robot pose and the payload in the scene (local-map) frame
    X_new = bk.compose_s(X_old, bk.inverse_s(bk.compose_s(S, T)))
    M = bk.compose_s(X_new, S)
    cM, sM = torch.cos(M[2]), torch.sin(M[2])
    pay_x = cM * upd_px - sM * upd_py + M[0]
    pay_y = sM * upd_px + cM * upd_py + M[1]
    pay_nx = cM * upd_nx - sM * upd_ny
    pay_ny = sM * upd_nx + cM * upd_ny

    n_app_ok = mg["app_ok"].to(torch.float32).sum(dim=-1, keepdim=True)
    stats_row = torch.zeros(K, B, device=dev)
    stats_row[:, 0:7] = torch.cat([T[0], T[1], T[2], s[10], s[9], s[12], n_app_ok], dim=1)
    payload = torch.stack([pay_x, pay_y, pay_nx, pay_ny, mg["target"], mg["kind"],
                           stats_row, iter_row])

    # new cache: the post-merge visible cell per beam, current sensor frame
    zeros = torch.zeros(K, B, device=dev)
    cacheB_new = torch.stack(mg["cache"] + (zeros, zeros))

    count_new = torch.clamp(count + n_app, max=cap)
    new_last_odom = torch.where(ov > 0, odom, last_odom)
    new_has = torch.maximum(has_odom, ov)
    poseB_new = torch.cat(
        [X_new[0], X_new[1], X_new[2],
         new_last_odom[0], new_last_odom[1], new_last_odom[2],
         new_has, count_new, S[0], S[1], S[2], torch.zeros(K, 5, device=dev)], dim=1)
    return cacheB_new, poseB_new, payload


def track_streams_grid_plain(spec: FrameSpec, cacheB, poseB, measC_stack, odom_stack):
    """Plain PyTorch version of ``track_streams_grid``: T frames in order,
    all K streams at once on [K, B] rows."""
    _check_spec(spec)
    payloads = []
    for t in range(measC_stack.shape[0]):
        cacheB, poseB, pay = _frame_body_b_plain(spec, measC_stack[t], cacheB, poseB,
                                                 odom_stack[t])
        payloads.append(pay)
    return cacheB, poseB, torch.stack(payloads)


# ------------------------------------------------------------ CUDA kernel

@profiling.span("stream.track_streams_grid")
def track_streams_grid(spec: FrameSpec, cacheB: torch.Tensor, poseB: torch.Tensor,
                       measC_stack: torch.Tensor, odom_stack: torch.Tensor):
    """Track K streams over T frames as ONE launch. measC_stack [T, 8, K, B],
    odom_stack [T, K, 8] -> (cacheB', poseB', payloads [T, 8, K, B]). CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    global launches
    _check_spec(spec)
    if measC_stack.device.type == "cpu":
        return track_streams_grid_plain(spec, cacheB, poseB, measC_stack, odom_stack)
    if measC_stack.device.type != "cuda":
        raise ValueError(f"unsupported device {measC_stack.device}")
    B = spec.cols_padded
    T, _, K, _ = measC_stack.shape
    dev = measC_stack.device
    _cuda.check_tensor("measC_stack", measC_stack, (T, 8, K, B), dev)
    _cuda.check_tensor("odom_stack", odom_stack, (T, K, 8), dev)
    _cuda.check_tensor("cacheB", cacheB, (8, K, B), dev)
    _cuda.check_tensor("poseB", poseB, (K, 16), dev)
    _cuda.check_aligned("measC_stack", measC_stack)
    _cuda.check_aligned("odom_stack", odom_stack)
    if B > 1024 or B % 128 or spec.window % 128 or spec.window > B:
        raise ValueError(f"cols_padded {B} must be a multiple of 128 and <= 1024, "
                         f"window {spec.window} a multiple of 128 within it")
    if K < 1 or T < 1:
        raise ValueError(f"need at least one stream and one frame, got K={K} T={T}")
    out_cache = torch.empty_like(cacheB)
    out_pose = torch.empty_like(poseB)
    payloads = torch.empty((T, 8, K, B), dtype=torch.float32, device=dev)
    lib = _cuda.load("stream_kernel")
    params = _params(spec, T, K)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.stream_track_grid(
            measC_stack.data_ptr(), odom_stack.data_ptr(), cacheB.data_ptr(),
            poseB.data_ptr(), out_cache.data_ptr(), out_pose.data_ptr(),
            payloads.data_ptr(), ctypes.addressof(params), stream)
    if err != 0:
        raise RuntimeError(f"stream kernel launch failed: {_cuda.error_string(err)}")
    launches += 1
    return out_cache, out_pose, payloads


def stream_step(spec: FrameSpec, measC: torch.Tensor, odomB: torch.Tensor,
                cacheB: torch.Tensor, poseB: torch.Tensor):
    """One frame for K streams ([8, K, B] canvas, [K, 8] odometry): the same
    kernel with T = 1. Returns (cacheB', poseB', payload [8, K, B])."""
    c, p, pay = track_streams_grid(spec, cacheB, poseB, measC[None].contiguous(),
                                   odomB[None].contiguous())
    return c, p, pay[0]


# ------------------------------------------------------- layout adapters

def pack_stream_state(cacheTs: torch.Tensor, poses: torch.Tensor):
    """K single-stream states -> (cacheB [8, K, B], poseB [K, 16]).
    cacheTs [K, 8, B] and poses [K, 2, 8] are stacked ``frame_kernel``
    caches and pose blocks."""
    cacheB = cacheTs.permute(1, 0, 2).contiguous()
    poseB = torch.zeros(poses.shape[0], 16, dtype=torch.float32, device=poses.device)
    poseB[:, 0:8] = poses[:, 0, 0:8]
    poseB[:, 8:11] = poses[:, 1, 0:3]
    return cacheB, poseB


def unpack_stream_state(cacheB: torch.Tensor, poseB: torch.Tensor):
    """Inverse of ``pack_stream_state`` -> ([K, 8, B] caches, [K, 2, 8]
    pose blocks)."""
    cacheTs = cacheB.permute(1, 0, 2).contiguous()
    poses = torch.zeros(poseB.shape[0], 2, 8, dtype=torch.float32, device=poseB.device)
    poses[:, 0, 0:8] = poseB[:, 0:8]
    poses[:, 1, 0:3] = poseB[:, 8:11]
    return cacheTs, poses


def pack_stream_measurements(measC_stacks: torch.Tensor, odoms: torch.Tensor,
                             odom_valid: torch.Tensor | None = None):
    """K per-stream canvas stacks [K, T, 8, B] (without the odometry lanes
    of row 6) and odometry [K, T, 3] -> (measC_stack [T, 8, K, B],
    odom_stack [T, K, 8]). ``odom_valid`` [K, T] defaults to all valid."""
    K, T = measC_stacks.shape[:2]
    measC_stack = measC_stacks.permute(1, 2, 0, 3).contiguous()
    odom_stack = torch.zeros(T, K, 8, dtype=torch.float32, device=measC_stacks.device)
    odom_stack[:, :, 0:3] = odoms.permute(1, 0, 2)
    odom_stack[:, :, 3] = 1.0 if odom_valid is None else odom_valid.t()
    return measC_stack, odom_stack
