"""Multi-cue projective alignment as one kernel: the aligner of the
dual-rangefinder tracker. Counterpart of
``srrg2_laser_slam_2d_tpu/ops/pallas_multicue_align.py``
(``fused_projective_align_multi``).

Each cue c (a rangefinder at sensor-in-robot pose e_c) has its measurement
z-buffered once into a canvas at identity in its own sensor frame. Every
Gauss-Newton pass moves the shared moving cloud (the per-cue clips,
concatenated in the previous robot frame) by inverse(e_c) * T and matches
every row against cue c's canvas (dense: all beams). Each cue's 13 sums are
normal equations in the cue-frame increment; the remap by A_c
(``remap_sums9``) turns them into robot-frame ones, which are added over the
cues before the odometry prior, the damping and the 3x3 solve. The update
needs ``min_inliers`` inliers and ``max(min_corr, 1)`` correspondences. A
fixed number of passes, no moving-side z-buffer: the same accepted
differences from ``icp.align_multi`` as the TPU kernel. The CUDA kernel is
``csrc/multicue_align_kernel.cu``; ``fused_projective_align_multi_plain``
is its plain PyTorch version.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import geometry
from . import _beam_kernels as bk
from . import _cuda
from .frame_kernel import _params
from .projective_align_kernel import (MAX_ITERATIONS, ProjAlignResult, align_spec,
                                      check_iterations)
from .projector import PolarProjection
from .projector_kernel import cols_padded

# launches of the CUDA kernel, and the moving and fixed rows they took,
# summed over the launches from the shapes (reset by callers that count a run)
launches = 0
moving_rows = 0
fixed_rows = 0
MAX_CUES = 4
MAX_MOVING = 4096   # moving rows the kernel packs in shared memory
_P, _I, _F = _cuda.PTR, _cuda.INT, _cuda.FLOAT
# fixed (xy, normal, valid, cues, rows), moving (xy, normal, valid, rows), t0,
# prior, extrinsics, three outputs, params (the frame kernel's), damping,
# min_corr, stream
MULTICUE_ALIGN = _cuda.Entry("multicue_align_kernel", "multicue_align",
                             [_P] * 3 + [_I] * 2 + [_P] * 3 + [_I] + [_P] * 7 + [_F] * 2 + [_P])
# terms, cues, out, threads, stream: the reduction alone (for tests)
MULTICUE_BLOCK_SUMS_TEST = _cuda.Entry("multicue_align_kernel", "multicue_block_sums_test",
                                       [_P, _I, _P, _I, _P])


def flops_per_pass(n_cues: int, n_moving: int) -> int:
    """Floating-point operations of one pass: 110 per moving row and cue
    (43 for the transform and beam assignment, 54 for the match and the
    normal-equation terms, 13 for the sums), plus 60 per cue for the cue
    pose, the remap and the solve."""
    return n_cues * (110 * n_moving + 60)


def remap_sums9(sums9, a00, a01, a02, a10, a11, a12):
    """H -> A^T H A, b -> A^T b for A = [[a00, a01, a02], [a10, a11, a12],
    [0, 0, 1]] on the 9 unique normal-equation sums (h00 h01 h02 h11 h12
    h22 b0 b1 b2), in the TPU kernel's order of operations."""
    h00, h01, h02, h11, h12, h22, b0, b1, b2 = sums9
    m00 = h00 * a00 + h01 * a10
    m01 = h00 * a01 + h01 * a11
    m02 = h00 * a02 + h01 * a12 + h02
    m10 = h01 * a00 + h11 * a10
    m11 = h01 * a01 + h11 * a11
    m12 = h01 * a02 + h11 * a12 + h12
    m22 = h02 * a02 + h12 * a12 + h22
    return (a00 * m00 + a10 * m10, a00 * m01 + a10 * m11, a00 * m02 + a10 * m12,
            a01 * m01 + a11 * m11, a01 * m02 + a11 * m12, a02 * m02 + a12 * m12 + m22,
            a00 * b0 + a10 * b1, a01 * b0 + a11 * b1, a02 * b0 + a12 * b1 + b2)


def cue_constants(extrinsics: torch.Tensor) -> torch.Tensor:
    """[C, 8] per cue: inverse(e_c) (unwrapped angle), then the translation
    column (a02, a12) of A_c, zeros. The kernel computes the same at the
    start of its launch."""
    e = extrinsics.to(torch.float32)
    ce, se = torch.cos(e[:, 2]), torch.sin(e[:, 2])
    tex, tey = e[:, 0], e[:, 1]
    out = torch.zeros(e.shape[0], 8, dtype=torch.float32, device=e.device)
    out[:, 0:3] = geometry.inverse(e)
    out[:, 3] = ce * (-tey) + se * tex
    out[:, 4] = -se * (-tey) + ce * tex
    return out


def _check(fixed_xy, iterations) -> None:
    check_iterations(iterations)
    if fixed_xy.dim() != 3 or not 1 <= fixed_xy.shape[0] <= MAX_CUES:
        raise ValueError(f"fixed clouds must be [C, N, 2] with 1 <= C <= {MAX_CUES}, "
                         f"got {tuple(fixed_xy.shape)}")


def fused_projective_align_multi_plain(proj, fixed_xy, fixed_normal, fixed_valid, extrinsics,
                                       moving_xy, moving_normal, moving_valid, initial,
                                       odom_prior=None, iterations=10, point_distance=0.5,
                                       normal_cos=0.8, chi_threshold=0.05, min_inliers=10,
                                       min_corr=1, odom_weight=0.0,
                                       damping=0.0) -> ProjAlignResult:
    """Plain PyTorch version of ``fused_projective_align_multi``: the cues
    are one batch axis of the moving-cloud match."""
    _check(fixed_xy, iterations)
    B = cols_padded(proj)
    n_cues = fixed_xy.shape[0]
    cue = cue_constants(extrinsics)
    canvases = torch.stack([
        bk.build_canvasT(fixed_xy[c, :, 0], fixed_xy[c, :, 1], fixed_normal[c, :, 0],
                         fixed_normal[c, :, 1], fixed_valid[c], B, proj)
        for c in range(n_cues)], dim=1)                                   # [8, C, B]
    m_pad = ((moving_xy.shape[0] + 127) // 128) * 128
    pad = m_pad - moving_xy.shape[0]
    mov = tuple(torch.nn.functional.pad(x.to(torch.float32), (0, pad)) for x in (
        moving_xy[:, 0], moving_xy[:, 1], moving_normal[:, 0], moving_normal[:, 1],
        moving_valid))
    inv_e = cue[:, 0:3].T[..., None]                                      # [3, C, 1]
    ci, si = torch.cos(cue[:, 2]), torch.sin(cue[:, 2])
    remap = (ci, -si, cue[:, 3], si, ci, cue[:, 4])

    def stats_of(T):
        f = bk.moving_fields(mov, bk.compose_s(inv_e, T[:, None, None]), proj)   # [C, m_pad]
        s = bk.banded_stats(canvases, f, B, point_distance, normal_cos, chi_threshold,
                            window=B)                                     # [13, C]
        r9 = remap_sums9(tuple(s[k] for k in range(9)), *remap)
        return [v.sum(0) for v in r9] + [s[k].sum(0) for k in range(9, 13)]

    T = initial.to(torch.float32)
    prior = (initial if odom_prior is None else odom_prior).to(torch.float32)
    records = []
    for _ in range(iterations):
        s = stats_of(T)
        records.append(torch.stack([s[10], s[9], s[12], s[11]]))
        sums9 = tuple(s[:9])
        if odom_weight > 0:
            sums9 = bk.add_odom_prior(sums9, T, prior, odom_weight)
        h00, h01, h02, h11, h12, h22, b0, b1, b2 = sums9
        dx = bk.solve3_sym(h00 + damping, h01, h02, h11 + damping, h12, h22 + damping,
                           -b0, -b1, -b2, 1e-20)
        guard = (s[12] >= min_inliers) & (s[9] >= max(min_corr, 1))
        T = bk.compose_s(torch.stack([torch.where(guard, v, torch.zeros_like(v))
                                      for v in dx]), T)
    s = stats_of(T)
    iters = torch.stack(records) if records else torch.zeros(0, 4, device=T.device)
    return ProjAlignResult(T, s[10], s[9], s[12], s[11], iters)


def fused_projective_align_multi(proj: PolarProjection, fixed_xy, fixed_normal, fixed_valid,
                                 extrinsics, moving_xy, moving_normal, moving_valid, initial,
                                 odom_prior=None, iterations=10, point_distance=0.5,
                                 normal_cos=0.8, chi_threshold=0.05, min_inliers=10,
                                 min_corr=1, odom_weight=0.0, damping=0.0) -> ProjAlignResult:
    """The whole multi-cue alignment as one launch: drop-in for
    ``icp.align_multi`` (same frames: fixed [C, N, ...] per-cue clouds in
    their sensor frames, extrinsics [C, 3], moving [M, ...] in the previous
    robot frame, estimate prev-robot -> curr-robot). CUDA tensors launch
    the kernel; CPU tensors take the plain version."""
    global launches, moving_rows, fixed_rows
    _check(fixed_xy, iterations)
    if not _cuda.on_card(fixed_xy):
        return fused_projective_align_multi_plain(
            proj, fixed_xy, fixed_normal, fixed_valid, extrinsics, moving_xy, moving_normal,
            moving_valid, initial, odom_prior, iterations, point_distance, normal_cos,
            chi_threshold, min_inliers, min_corr, odom_weight, damping)
    dev = fixed_xy.device
    C, N = fixed_xy.shape[0], fixed_xy.shape[1]
    fxy, fnm, fv = _cuda.cloud_tensors("fixed", fixed_xy.reshape(C * N, 2),
                                       fixed_normal.reshape(C * N, 2),
                                       fixed_valid.reshape(C * N), dev)
    mxy, mnm, mv = _cuda.cloud_tensors("moving", moving_xy, moving_normal, moving_valid, dev)
    t0 = initial.to(torch.float32).contiguous()
    prior = (initial if odom_prior is None else odom_prior).to(torch.float32).contiguous()
    extr = extrinsics.to(torch.float32).contiguous()
    _cuda.check_tensor("initial", t0, (3,), dev)
    _cuda.check_tensor("odom_prior", prior, (3,), dev)
    _cuda.check_tensor("extrinsics", extr, (C, 3), dev)
    B = cols_padded(proj)
    if B > 1024:
        raise ValueError(f"{proj.cols} beams: the kernel holds at most 1024")
    if mxy.shape[0] > MAX_MOVING:
        raise ValueError(f"{mxy.shape[0]} moving rows: the kernel holds at most {MAX_MOVING}")
    spec = align_spec(proj, iterations, point_distance, normal_cos, chi_threshold,
                      min_inliers, odom_weight)
    params = _params(spec, 1)
    params.B = B
    out = torch.empty(8 + 4 * MAX_ITERATIONS, dtype=torch.float32, device=dev)
    base = out.data_ptr()
    MULTICUE_ALIGN(dev, fxy.data_ptr(), fnm.data_ptr(), fv.data_ptr(), C, N,
                   mxy.data_ptr(), mnm.data_ptr(), mv.data_ptr(), mxy.shape[0],
                   t0.data_ptr(), prior.data_ptr(), extr.data_ptr(), base, base + 16, base + 32,
                   ctypes.addressof(params), float(damping), float(max(min_corr, 1)))
    launches += 1
    moving_rows += mxy.shape[0]
    fixed_rows += C * N
    iters = out[8:].reshape(4, MAX_ITERATIONS)[:, :iterations].T
    return ProjAlignResult(out[0:3], out[4], out[5], out[6], out[7], iters)
