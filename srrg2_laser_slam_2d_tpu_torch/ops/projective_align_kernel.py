"""Dense beam-space projective alignment as one kernel. Counterpart of
``srrg2_laser_slam_2d_tpu/ops/pallas_projective_align.py``
(``fused_projective_align``).

The fixed cloud is z-buffered once into a canvas; every Gauss-Newton pass
moves the moving cloud by the current estimate, z-buffers it as well
(closest depth per beam, ties averaged), matches the two canvases beam by
beam under the depth and normal gates, adds the odometry prior and solves
the 3x3 system in closed form; a last pass gives the final statistics. The
CUDA kernel is ``csrc/projective_align_kernel.cu``;
``fused_projective_align_plain`` is its plain PyTorch version (dense [N, B]
compares).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _beam_kernels as bk
from . import _cuda
from .frame_kernel import FrameSpec, _params
from .projector import PolarProjection
from .projector_kernel import cols_padded

# launches of the CUDA kernel (reset by callers that count a run)
launches = 0
MAX_ITERATIONS = 128
MAX_BEAMS = 1024          # padded beams: one block of at most 1,024 lanes
# fixed (xy, normal, valid, rows), moving (xy, normal, valid, rows), t0, prior,
# three outputs, params (the frame kernel's), stream: both aligners' C interface
ALIGN_ARGS = ([_cuda.PTR] * 3 + [_cuda.INT]) * 2 + [_cuda.PTR] * 7
PROJECTIVE_ALIGN = _cuda.Entry("projective_align_kernel", "projective_align", ALIGN_ARGS)


class ProjAlignResult(NamedTuple):
    estimate: torch.Tensor      # [3] moving-in-fixed (angle not wrapped)
    chi: torch.Tensor           # [] total chi of the final pass
    num_corr: torch.Tensor      # [] float32
    num_inliers: torch.Tensor   # [] float32
    chi_inl_sum: torch.Tensor   # [] chi summed over the inliers, final pass
    iter_stats: torch.Tensor    # [iterations, 4]: chi, n_corr, n_inliers, chi_inl_sum


# operations to z-buffer one fixed point into the canvas (beam assignment 37,
# tie average 9)
FLOPS_PER_CANVAS_POINT = 46


def flops_per_pass(n_moving: int, beams: int) -> int:
    """Floating-point operations of one pass of the dense aligner: 52 per
    moving point (43 for the transform and beam assignment as the frame
    kernel counts them, 9 for the tie average), 67 per beam for the match,
    the normal-equation terms and the block sums."""
    return 52 * n_moving + 67 * beams


def check_iterations(iterations: int) -> None:
    if iterations > MAX_ITERATIONS:
        raise ValueError("iterationStats record supports <= 128 iterations")


def align_spec(proj: PolarProjection, iterations, point_distance, normal_cos,
               chi_threshold, min_inliers, odom_weight) -> FrameSpec:
    """The aligner's arguments as the static configuration the shared
    device functions read (window 256: the banded aligner's)."""
    return FrameSpec(projection=proj, iterations=int(iterations),
                     point_distance=float(point_distance), normal_cos=float(normal_cos),
                     chi_threshold=float(chi_threshold), min_inliers=int(min_inliers),
                     odom_weight=float(odom_weight), window=bk.WINDOW)


def gn_step(s: torch.Tensor, T: torch.Tensor, prior: torch.Tensor, spec: FrameSpec):
    """One update from the 13 sums: odometry prior, Cramer solve (guard
    1e-20), inlier guard, pre-multiplied compose (angle not wrapped)."""
    sums9 = tuple(s[k] for k in range(9))
    if spec.odom_weight > 0:
        sums9 = bk.add_odom_prior(sums9, T, prior, spec.odom_weight)
    h00, h01, h02, h11, h12, h22, b0, b1, b2 = sums9
    dx = bk.solve3_sym(h00, h01, h02, h11, h12, h22, -b0, -b1, -b2, 1e-20)
    guard = s[9] >= spec.min_inliers
    dx = torch.stack([torch.where(guard, v, torch.zeros_like(v)) for v in dx])
    return bk.compose_s(dx, T)


def run_passes(stats_of, spec: FrameSpec, initial, prior) -> ProjAlignResult:
    """The loop both aligners share: ``stats_of(T)`` -> the 13 sums."""
    T = initial.to(torch.float32)
    prior = prior.to(torch.float32)
    records = []
    for _ in range(spec.iterations):
        s = stats_of(T)
        records.append(torch.stack([s[10], s[9], s[12], s[11]]))
        T = gn_step(s, T, prior, spec)
    s = stats_of(T)
    iters = torch.stack(records) if records else torch.zeros(0, 4, device=T.device)
    return ProjAlignResult(T, s[10], s[9], s[12], s[11], iters)


def fused_projective_align_plain(proj, fixed_xy, fixed_normal, fixed_valid,
                                 moving_xy, moving_normal, moving_valid, initial,
                                 odom_prior=None, iterations=10, point_distance=0.5,
                                 normal_cos=0.8, chi_threshold=0.05, min_inliers=10,
                                 odom_weight=0.0) -> ProjAlignResult:
    """Plain PyTorch version of ``fused_projective_align``."""
    check_iterations(iterations)
    spec = align_spec(proj, iterations, point_distance, normal_cos, chi_threshold,
                      min_inliers, odom_weight)
    B = cols_padded(proj)
    canvasT = bk.build_canvasT(fixed_xy[:, 0], fixed_xy[:, 1], fixed_normal[:, 0],
                               fixed_normal[:, 1], fixed_valid, B, proj)
    mov = (moving_xy[:, 0], moving_xy[:, 1], moving_normal[:, 0], moving_normal[:, 1],
           moving_valid)

    def stats_of(T):
        f = bk.moving_fields(mov, T, proj)
        m = bk.build_canvasT(f["px"], f["py"], f["nx"], f["ny"], moving_valid, B, proj)
        beam = dict(px=m[1], py=m[2], nx=m[3], ny=m[4], d=m[0])
        return bk.match_terms(canvasT[:6], beam, spec.point_distance, spec.normal_cos,
                              spec.chi_threshold).sum(dim=-1)

    return run_passes(stats_of, spec, initial, initial if odom_prior is None else odom_prior)


@functools.lru_cache(maxsize=64)
def _launch_params(spec: FrameSpec, B: int):
    """The kernels' parameter struct for ``spec`` at B padded beams, built
    once per (spec, B); the C entry points copy it at each launch."""
    params = _params(spec, 1)
    params.B = B
    return params


def aligner_inputs(spec: FrameSpec, B: int, fixed, moving, initial, prior, device):
    """The arguments as the kernels take them, or a ValueError: at most
    ``MAX_BEAMS`` padded beams (any number of rows); every cloud field a
    contiguous tensor of its type and shape on ``device`` (float32 [N, 2]
    xy and normal, bool [N] valid); ``initial`` and ``prior`` [3] there too
    (cast to float32)."""
    if B > MAX_BEAMS:
        raise ValueError(f"{spec.projection.cols} beams ({B} padded): the kernel holds at most "
                         f"{MAX_BEAMS}")
    for name, cloud in (("fixed", fixed), ("moving", moving)):
        for field, t in zip(("xy", "normal", "valid"), cloud):
            if not t.is_contiguous():
                raise ValueError(f"{name}.{field}: the kernel needs a contiguous tensor")
    fxy, fnm, fv = _cuda.cloud_tensors("fixed", *fixed, device)
    mxy, mnm, mv = _cuda.cloud_tensors("moving", *moving, device)
    t0 = initial.to(torch.float32).contiguous()
    prior_t = prior.to(torch.float32).contiguous()
    _cuda.check_tensor("initial", t0, (3,), device)
    _cuda.check_tensor("odom_prior", prior_t, (3,), device)
    return fxy, fnm, fv, mxy, mnm, mv, t0, prior_t


def launch_aligner(entry: _cuda.Entry, spec: FrameSpec, B: int, fixed, moving, initial,
                   prior) -> ProjAlignResult:
    """Launch one of the two aligner kernels (they share a C interface)."""
    dev = fixed[0].device
    fxy, fnm, fv, mxy, mnm, mv, t0, prior_t = aligner_inputs(spec, B, fixed, moving, initial,
                                                             prior, dev)
    out = torch.empty(8 + 4 * MAX_ITERATIONS, dtype=torch.float32, device=dev)
    base = out.data_ptr()
    entry(dev, fxy.data_ptr(), fnm.data_ptr(), fv.data_ptr(), fxy.shape[0],
          mxy.data_ptr(), mnm.data_ptr(), mv.data_ptr(), mxy.shape[0],
          t0.data_ptr(), prior_t.data_ptr(), base, base + 16, base + 32,
          ctypes.addressof(_launch_params(spec, B)))
    iters = out[8:].reshape(4, MAX_ITERATIONS)[:, : spec.iterations].T
    return ProjAlignResult(out[0:3], out[4], out[5], out[6], out[7], iters)


def fused_projective_align(proj: PolarProjection, fixed_xy, fixed_normal, fixed_valid,
                           moving_xy, moving_normal, moving_valid, initial,
                           odom_prior=None, iterations=10, point_distance=0.5,
                           normal_cos=0.8, chi_threshold=0.05, min_inliers=10,
                           odom_weight=0.0) -> ProjAlignResult:
    """The whole projective alignment as one launch. ``initial`` is
    moving-in-fixed; the fixed cloud lies in the (identity-camera) fixed
    frame. CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    global launches
    check_iterations(iterations)
    if not _cuda.on_card(fixed_xy):
        return fused_projective_align_plain(
            proj, fixed_xy, fixed_normal, fixed_valid, moving_xy, moving_normal,
            moving_valid, initial, odom_prior, iterations, point_distance, normal_cos,
            chi_threshold, min_inliers, odom_weight)
    spec = align_spec(proj, iterations, point_distance, normal_cos, chi_threshold,
                      min_inliers, odom_weight)
    res = launch_aligner(PROJECTIVE_ALIGN, spec, cols_padded(proj),
                         (fixed_xy, fixed_normal, fixed_valid),
                         (moving_xy, moving_normal, moving_valid), initial,
                         initial if odom_prior is None else odom_prior)
    launches += 1
    return res
