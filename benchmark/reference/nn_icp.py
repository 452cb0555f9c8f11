"""A frozen copy of the port's plain NN-ICP pair alignment
(``fused_align_pairs_plain``, ``pack_fixed``, ``pack_moving`` of
``ops/nn_icp_kernel.py``, kernel 2's plain version), as the benchmark was
written. The corridor cell's reference for kernel 2.

Plain PyTorch; floating tensors take the default dtype (``_f()``), and no
product runs in TF32 (``precision.computed_in``).
"""

from __future__ import annotations

import torch

from . import beam

_BIG = 1.0e30
TILE_F = 512


def _f() -> torch.dtype:
    return torch.get_default_dtype()


def pack_fixed(fixed) -> torch.Tensor:
    """[J, 6, F] rows (x, y, nx, ny, valid, |f|^2 + penalty); invalid fixed
    points carry |f|^2 + 1e30 and never win a match."""
    valid_f = fixed.valid.to(_f())
    xy = fixed.xy
    f2 = (xy[..., 0] * xy[..., 0] + xy[..., 1] * xy[..., 1]) + torch.where(
        valid_f > 0, 0.0, _BIG)
    return torch.stack([xy[..., 0], xy[..., 1], fixed.normal[..., 0],
                        fixed.normal[..., 1], valid_f, f2], dim=-2).contiguous()


def pack_moving(moving) -> torch.Tensor:
    """[J, 5, M] rows (x, y, nx, ny, valid)."""
    return torch.stack([moving.xy[..., 0], moving.xy[..., 1],
                        moving.normal[..., 0], moving.normal[..., 1],
                        moving.valid.to(_f())], dim=-2).contiguous()


def nn_passes(iterations: int, corr_refresh: int) -> int:
    """Nearest-neighbour passes of one alignment: one per refresh period and
    the final pass that scores the solution."""
    refresh = max(int(corr_refresh), 1)
    return -(-iterations // refresh) + 1


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
            onehot = (d2 <= tile_best).to(_f())
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
        n_ok = tot(ok.to(_f()))
        dx = torch.stack(beam.solve3_sym(h00, h01, h02, h11, h12, h22,
                                       -b0, -b1, -b2, 1e-12), dim=1)
        dx = torch.where((n_ok >= min_inliers)[:, None], dx, torch.zeros_like(dx))
        return beam.compose_s(dx.T, T.T).T

    T = initials.to(_f())
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
        inl.to(_f()).sum(dim=(1, 2)),
        ok.to(_f()).sum(dim=(1, 2)),
        torch.where(inl, chi_pt, 0.0).sum(dim=(1, 2)),
    ], dim=1)
    return T, stats


def align_pairs(fixed, moving, initials, iterations: int, max_distance: float,
                normal_cos: float, chi_threshold: float, min_inliers: int,
                corr_refresh: int):
    """J cloud pairs ([J, N, ...] each, ``initials`` [J, 3]) -> (estimate
    [J, 3], inliers [J], correspondences [J], mean inlier chi [J])."""
    est, stats = fused_align_pairs_plain(pack_fixed(fixed), pack_moving(moving), initials,
                                         iterations, float(max_distance) ** 2,
                                         float(normal_cos), float(chi_threshold),
                                         int(min_inliers), int(corr_refresh))
    return est, stats[:, 1], stats[:, 2], stats[:, 3] / torch.clamp(stats[:, 1], min=1.0)
