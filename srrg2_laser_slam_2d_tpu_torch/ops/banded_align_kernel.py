"""Banded projective alignment as one kernel: the per-message tracker's
aligner. Counterpart of ``srrg2_laser_slam_2d_tpu/ops/pallas_banded_align.py``
(``fused_projective_align_banded``).

Same role as ``projective_align_kernel.fused_projective_align``, for a
moving cloud that is beam-indexed (row r is the cell last seen on beam r:
the projective clip or the merge-canvas cache): each pass moves lane r by
the estimate and matches it against the fixed canvas cell of its new beam
while that beam lies in the 256-beam window of the lane's 128-beam block.
There is no moving-side z-buffer, so two lanes landing on one beam both
match, and each lane's own depth enters the depth gate. The CUDA kernel is
``csrc/banded_align_kernel.cu``; ``fused_projective_align_banded_plain`` is
its plain PyTorch version.
"""

from __future__ import annotations

import torch

from . import _beam_kernels as bk
from . import _cuda
from .projective_align_kernel import (ALIGN_ARGS, ProjAlignResult, align_spec,
                                      check_iterations, launch_aligner, run_passes)
from .projector import PolarProjection

# launches of the CUDA kernel (reset by callers that count a run)
launches = 0
BANDED_ALIGN = _cuda.Entry("banded_align_kernel", "banded_align", ALIGN_ARGS)


def flops_per_pass(beams: int) -> int:
    """Floating-point operations of one pass of the banded aligner per
    launch: 110 per lane (the frame kernel's Gauss-Newton pass)."""
    return 110 * beams


def _check_beam_indexed(proj: PolarProjection, moving_xy) -> None:
    if moving_xy.shape[0] != proj.cols:
        raise ValueError(f"banded aligner needs beam-indexed moving cloud "
                         f"({moving_xy.shape[0]} rows != {proj.cols} beams)")


def fused_projective_align_banded_plain(proj, fixed_xy, fixed_normal, fixed_valid,
                                        moving_xy, moving_normal, moving_valid, initial,
                                        odom_prior=None, iterations=10, point_distance=0.5,
                                        normal_cos=0.8, chi_threshold=0.05, min_inliers=10,
                                        odom_weight=0.0) -> ProjAlignResult:
    """Plain PyTorch version of ``fused_projective_align_banded``."""
    _check_beam_indexed(proj, moving_xy)
    check_iterations(iterations)
    spec = align_spec(proj, iterations, point_distance, normal_cos, chi_threshold,
                      min_inliers, odom_weight)
    B = spec.cols_padded
    canvasT = bk.build_canvasT(fixed_xy[:, 0], fixed_xy[:, 1], fixed_normal[:, 0],
                               fixed_normal[:, 1], fixed_valid, B, proj)
    pad = B - moving_xy.shape[0]
    mov = tuple(torch.nn.functional.pad(x.to(torch.float32), (0, pad)) for x in (
        moving_xy[:, 0], moving_xy[:, 1], moving_normal[:, 0], moving_normal[:, 1],
        moving_valid))

    def stats_of(T):
        return bk.banded_stats(canvasT, bk.moving_fields(mov, T, proj), B,
                               spec.point_distance, spec.normal_cos, spec.chi_threshold,
                               window=spec.window)

    return run_passes(stats_of, spec, initial, initial if odom_prior is None else odom_prior)


def fused_projective_align_banded(proj: PolarProjection, fixed_xy, fixed_normal,
                                  fixed_valid, moving_xy, moving_normal, moving_valid,
                                  initial, odom_prior=None, iterations=10,
                                  point_distance=0.5, normal_cos=0.8, chi_threshold=0.05,
                                  min_inliers=10, odom_weight=0.0) -> ProjAlignResult:
    """Banded drop-in for ``fused_projective_align``; the moving cloud must
    have one row per beam of ``proj``. CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    global launches
    _check_beam_indexed(proj, moving_xy)
    check_iterations(iterations)
    if not _cuda.on_card(fixed_xy):
        return fused_projective_align_banded_plain(
            proj, fixed_xy, fixed_normal, fixed_valid, moving_xy, moving_normal,
            moving_valid, initial, odom_prior, iterations, point_distance, normal_cos,
            chi_threshold, min_inliers, odom_weight)
    spec = align_spec(proj, iterations, point_distance, normal_cos, chi_threshold,
                      min_inliers, odom_weight)
    res = launch_aligner(BANDED_ALIGN, spec, spec.cols_padded,
                         (fixed_xy, fixed_normal, fixed_valid),
                         (moving_xy, moving_normal, moving_valid), initial,
                         initial if odom_prior is None else odom_prior)
    launches += 1
    return res
