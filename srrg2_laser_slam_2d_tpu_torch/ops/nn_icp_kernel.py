"""Bounded-nearest-neighbour point-to-plane ICP, all candidate pairs in one
launch.

Counterpart of ``srrg2_laser_slam_2d_tpu/ops/pallas_icp.py``
(``fused_align_nn`` / ``fused_align_pairs``, kernel ``_make_kernel``): per
pair, each moving point takes the nearest fixed point within
``max_distance`` (ties inside one 512-point tile are averaged; a later tile
wins only on a strictly smaller distance), gated by the normals; the
Cauchy-weighted normal equations give a Cramer 3x3 step (determinant guard
1e-12); ``corr_refresh`` keeps the matches frozen between refreshes. The
CUDA kernel is ``csrc/nn_icp_kernel.cu``; ``fused_align_pairs_plain`` is
its plain PyTorch version, batched over pairs.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _beam_kernels as bk
from . import _cuda
from ..utils.cloud import Cloud

_BIG = 1.0e30
TILE_F = 512
# operations of one fixed-moving distance in a nearest-neighbour pass: the
# cross term (4), the expanded squared distance (3) and the compare (1)
FLOPS_PER_DISTANCE = 8

# launches of the CUDA kernel, and the pairs aligned on either route
# (reset by callers that count a run)
launches = 0
pairs = 0


class FusedAlignResult(NamedTuple):
    estimate: torch.Tensor            # [J, 3]
    chi: torch.Tensor                 # [J]
    num_inliers: torch.Tensor         # [J] float32
    num_correspondences: torch.Tensor  # [J] float32
    chi_inliers: torch.Tensor         # [J] mean chi over inliers


def pack_fixed(fixed: Cloud) -> torch.Tensor:
    """[J, 6, F] rows (x, y, nx, ny, valid, |f|^2 + penalty); invalid fixed
    points carry |f|^2 + 1e30 and never win a match."""
    valid_f = fixed.valid.to(torch.float32)
    xy = fixed.xy
    f2 = (xy[..., 0] * xy[..., 0] + xy[..., 1] * xy[..., 1]) + torch.where(
        valid_f > 0, 0.0, _BIG)
    return torch.stack([xy[..., 0], xy[..., 1], fixed.normal[..., 0],
                        fixed.normal[..., 1], valid_f, f2], dim=-2).contiguous()


def pack_moving(moving: Cloud) -> torch.Tensor:
    """[J, 5, M] rows (x, y, nx, ny, valid)."""
    return torch.stack([moving.xy[..., 0], moving.xy[..., 1],
                        moving.normal[..., 0], moving.normal[..., 1],
                        moving.valid.to(torch.float32)], dim=-2).contiguous()


def nn_passes(iterations: int, corr_refresh: int) -> int:
    """Nearest-neighbour passes of one alignment: one per refresh period and
    the final pass that scores the solution."""
    refresh = max(int(corr_refresh), 1)
    return -(-iterations // refresh) + 1


def _result(est, stats) -> FusedAlignResult:
    return FusedAlignResult(
        estimate=est, chi=stats[:, 0], num_inliers=stats[:, 1],
        num_correspondences=stats[:, 2],
        chi_inliers=stats[:, 3] / torch.clamp(stats[:, 1], min=1.0))


# ------------------------------------------------------------ plain version

def fused_align_pairs_plain(fixedP: torch.Tensor, movingP: torch.Tensor,
                            initials: torch.Tensor, iterations: int,
                            max_distance2: float, normal_cos: float,
                            chi_threshold: float, min_inliers: int,
                            corr_refresh: int = 1, tile_f: int = TILE_F):
    """Packed inputs (``pack_fixed`` / ``pack_moving``) -> (estimate [J, 3],
    stats [J, 4] = chi, inliers, correspondences, inlier chi sum). The
    squared distance is the Pallas kernel's expansion
    |m|^2 + 2 (R^T t).m + |t|^2 + |f|^2 - 2 (m.(R^T f) + t.f)."""
    J, _, F = fixedP.shape
    if F % tile_f:
        raise ValueError(f"fixed capacity {F} must be a multiple of {tile_f}")
    mx0, my0 = movingP[:, 0, :, None], movingP[:, 1, :, None]     # [J, M, 1]
    mnx0, mny0 = movingP[:, 2, :, None], movingP[:, 3, :, None]
    mval = movingP[:, 4, :, None]
    m2 = mx0 * mx0 + my0 * my0

    def col(v):                                                   # [J] -> [J, 1, 1]
        return v[:, None, None]

    def transform(T):
        c, s = col(torch.cos(T[:, 2])), col(torch.sin(T[:, 2]))
        px = c * mx0 - s * my0 + col(T[:, 0])
        py = s * mx0 + c * my0 + col(T[:, 1])
        return px, py, c * mnx0 - s * mny0, s * mnx0 + c * mny0

    def nn_pass(T):
        c, s = col(torch.cos(T[:, 2])), col(torch.sin(T[:, 2]))
        tx, ty = col(T[:, 0]), col(T[:, 1])
        a = c * tx + s * ty
        b = -s * tx + c * ty
        p2 = m2 + 2.0 * (a * mx0 + b * my0) + (tx * tx + ty * ty)
        px, py, nx, ny = transform(T)
        best = torch.full_like(mx0, _BIG)
        pfx, pfy, nfx, nfy = (torch.zeros_like(mx0) for _ in range(4))
        for t in range(F // tile_f):
            tile = fixedP[:, :, t * tile_f:(t + 1) * tile_f]        # [J, 6, TF]
            fxx, fxy, f2_t = tile[:, 0:1], tile[:, 1:2], tile[:, 5:6]
            fxr = c * fxx + s * fxy
            fyr = -s * fxx + c * fxy
            tf = tx * fxx + ty * fxy
            cross = mx0 * fxr + my0 * fyr + tf                     # [J, M, TF]
            d2 = p2 + f2_t - 2.0 * cross
            tile_best = d2.min(dim=2, keepdim=True).values
            onehot = (d2 <= tile_best).to(torch.float32)
            cnt = torch.clamp(onehot.sum(dim=2, keepdim=True), min=1.0)
            # tied minima are averaged (the Pallas one-hot gather)
            g = torch.matmul(onehot, tile[:, 0:4].transpose(1, 2)) / cnt
            take = tile_best < best
            best = torch.where(take, tile_best, best)
            pfx = torch.where(take, g[..., 0:1], pfx)
            pfy = torch.where(take, g[..., 1:2], pfy)
            nfx = torch.where(take, g[..., 2:3], nfx)
            nfy = torch.where(take, g[..., 3:4], nfy)
        ndot = nfx * nx + nfy * ny
        ok = (mval > 0) & (best <= max_distance2) & (ndot >= normal_cos)
        return px, py, nx, ny, pfx, pfy, nfx, nfy, ok

    def solve_from(px, py, nx, ny, pfx, pfy, nfx, nfy, ok, T):
        e1 = nfx * (px - pfx) + nfy * (py - pfy)
        e2 = nx - nfx
        e3 = ny - nfy
        chi = e1 * e1 + e2 * e2 + e3 * e3
        if chi_threshold > 0:
            w = torch.where(chi < chi_threshold, torch.ones_like(chi),
                            chi_threshold / torch.clamp(chi, min=1e-20))
        else:
            w = torch.ones_like(chi)
        w = torch.where(ok, w, torch.zeros_like(w))
        j1c = nfx * (-py) + nfy * px
        sn2 = nx * nx + ny * ny

        def tot(v):
            return v.sum(dim=(1, 2))

        h00, h01, h02 = tot(w * nfx * nfx), tot(w * nfx * nfy), tot(w * nfx * j1c)
        h11, h12 = tot(w * nfy * nfy), tot(w * nfy * j1c)
        h22 = tot(w * (j1c * j1c + sn2))
        b0, b1 = tot(w * nfx * e1), tot(w * nfy * e1)
        b2 = tot(w * (j1c * e1 + (-ny) * e2 + nx * e3))
        n_ok = tot(ok.to(torch.float32))
        dx = torch.stack(bk.solve3_sym(h00, h01, h02, h11, h12, h22,
                                       -b0, -b1, -b2, 1e-12), dim=1)
        dx = torch.where((n_ok >= min_inliers)[:, None], dx, torch.zeros_like(dx))
        return bk.compose_s(dx.T, T.T).T

    T = initials.to(torch.float32)
    refresh = max(int(corr_refresh), 1)
    for i in range(nn_passes(iterations, refresh) - 1):
        px, py, nx, ny, pfx, pfy, nfx, nfy, ok = nn_pass(T)
        for sub in range(refresh):
            if i * refresh + sub >= iterations:
                break
            if sub > 0:
                px, py, nx, ny = transform(T)
            T = solve_from(px, py, nx, ny, pfx, pfy, nfx, nfy, ok, T)

    px, py, nx, ny, pfx, pfy, nfx, nfy, ok = nn_pass(T)
    e1 = nfx * (px - pfx) + nfy * (py - pfy)
    e2 = nx - nfx
    e3 = ny - nfy
    chi_pt = e1 * e1 + e2 * e2 + e3 * e3
    inl = ok & (chi_pt < chi_threshold)
    stats = torch.stack([
        torch.where(ok, chi_pt, 0.0).sum(dim=(1, 2)),
        inl.to(torch.float32).sum(dim=(1, 2)),
        ok.to(torch.float32).sum(dim=(1, 2)),
        torch.where(inl, chi_pt, 0.0).sum(dim=(1, 2)),
    ], dim=1)
    return T, stats


# ------------------------------------------------------------ CUDA kernel

class _NNParams(ctypes.Structure):
    """Mirror of ``NNParams`` in csrc/nn_icp_kernel.cu."""

    _fields_ = [
        ("J", ctypes.c_int), ("F", ctypes.c_int), ("M", ctypes.c_int),
        ("iterations", ctypes.c_int), ("refresh", ctypes.c_int),
        ("tile_f", ctypes.c_int),
        ("max_distance2", ctypes.c_float), ("normal_cos", ctypes.c_float),
        ("chi_threshold", ctypes.c_float), ("min_inliers", ctypes.c_float),
    ]


MAX_MOVING = 1024   # 256 threads x 4 points
MAX_FIXED = 4096    # 8 rows of F floats in shared memory


def _launch(fixedP, movingP, initials, iterations, max_distance2, normal_cos,
            chi_threshold, min_inliers, corr_refresh):
    global launches
    J, _, F = fixedP.shape
    M = movingP.shape[2]
    dev = fixedP.device
    if dev.type != "cuda":
        raise ValueError(f"the NN-ICP kernel runs on a CUDA device, not {dev}")
    _cuda.check_tensor("fixed", fixedP, (J, 6, F), dev)
    _cuda.check_tensor("moving", movingP, (J, 5, M), dev)
    _cuda.check_tensor("initials", initials, (J, 3), dev)
    if M > MAX_MOVING or F > MAX_FIXED:
        raise ValueError(f"moving {M} > {MAX_MOVING} or fixed {F} > {MAX_FIXED} points")
    est = torch.empty((J, 3), dtype=torch.float32, device=dev)
    stats = torch.empty((J, 4), dtype=torch.float32, device=dev)
    params = _NNParams(J=J, F=F, M=M, iterations=iterations,
                       refresh=max(int(corr_refresh), 1), tile_f=TILE_F,
                       max_distance2=max_distance2, normal_cos=normal_cos,
                       chi_threshold=chi_threshold, min_inliers=float(min_inliers))
    lib = _cuda.load("nn_icp_kernel")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nn_icp_align_pairs(
            fixedP.data_ptr(), movingP.data_ptr(), initials.data_ptr(),
            est.data_ptr(), stats.data_ptr(), ctypes.addressof(params), stream)
    if err != 0:
        raise RuntimeError(f"NN-ICP kernel launch failed: {_cuda.error_string(err)}")
    launches += 1
    return est, stats


def fused_align_pairs(fixed: Cloud, moving: Cloud, initials: torch.Tensor,
                      iterations: int = 30, max_distance: float = 1.414,
                      normal_cos: float = 0.8, chi_threshold: float = 0.05,
                      min_inliers: int = 10, corr_refresh: int = 1) -> FusedAlignResult:
    """Align J (fixed, moving) cloud pairs ([J, N, ...] each; ``initials``
    [J, 3] moving-in-fixed) in ONE launch. CUDA tensors launch the kernel;
    CPU tensors take the plain version."""
    global pairs
    pairs += initials.shape[0]
    fixedP, movingP = pack_fixed(fixed), pack_moving(moving)
    initials = initials.to(torch.float32).contiguous()
    args = (iterations, float(max_distance) ** 2, float(normal_cos),
            float(chi_threshold), int(min_inliers), int(corr_refresh))
    if fixedP.device.type == "cpu":
        est, stats = fused_align_pairs_plain(fixedP, movingP, initials, *args)
    elif fixedP.device.type == "cuda":
        est, stats = _launch(fixedP, movingP, initials, *args)
    else:
        raise ValueError(f"unsupported device {fixedP.device}")
    return _result(est, stats)
