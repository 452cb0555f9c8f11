"""A frozen copy of the beam-space arithmetic of the port's frame step
(``ops/_beam_kernels.py`` of the port as the benchmark was written): SE(2)
on pose lanes, the polynomial arctangent, the banded match and its
normal-equation terms, the shift z-buffer and the lean merge.

Plain PyTorch. Every floating tensor this module makes takes the default
dtype (``_f()``), so the control computes the same steps in bfloat16 under
``precision.computed_in``. The port may change; this copy may not.
"""

from __future__ import annotations

import torch

from .prep import PolarProjection


def _f() -> torch.dtype:
    """The floating dtype every tensor made here takes."""
    return torch.get_default_dtype()

_BIG = 1.0e30
WINDOW = 256


# ----------------------------------------------------------------- scalar SE2

def compose_s(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ca, sa = torch.cos(a[2]), torch.sin(a[2])
    return torch.stack([a[0] + ca * b[0] - sa * b[1],
                        a[1] + sa * b[0] + ca * b[1], a[2] + b[2]])


def inverse_s(a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a[2]), torch.sin(a[2])
    return torch.stack([-(c * a[0] + s * a[1]), -(-s * a[0] + c * a[1]), -a[2]])


def relative_s(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return compose_s(inverse_s(a), b)


def solve3_sym(a00, a01, a02, a11, a12, a22, b0, b1, b2, det_eps: float):
    """Closed-form symmetric 3x3 solve (Cramer). ``det_eps`` is the
    determinant guard: 1e-20 in the frame kernel, 1e-12 in the NN-ICP
    kernel (as in the two Pallas sources)."""
    a10, a20, a21 = a01, a02, a12
    det = (a00 * (a11 * a22 - a12 * a21)
           - a01 * (a10 * a22 - a12 * a20)
           + a02 * (a10 * a21 - a11 * a20))
    inv_det = torch.where(torch.abs(det) > det_eps, 1.0 / det,
                          torch.zeros_like(det))
    x0 = ((a11 * a22 - a12 * a21) * b0 + (a02 * a21 - a01 * a22) * b1
          + (a01 * a12 - a02 * a11) * b2) * inv_det
    x1 = ((a12 * a20 - a10 * a22) * b0 + (a00 * a22 - a02 * a20) * b1
          + (a02 * a10 - a00 * a12) * b2) * inv_det
    x2 = ((a10 * a21 - a11 * a20) * b0 + (a01 * a20 - a00 * a21) * b1
          + (a00 * a11 - a01 * a10) * b2) * inv_det
    return x0, x1, x2


# ------------------------------------------------------------------- atan2

def atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernels' polynomial arctangent (Abramowitz & Stegun 4.4.49,
    |err| <= 2e-8 rad). Beam assignment uses it, not ``torch.atan2``: a
    different arctangent moves points that lie on beam-bin edges."""
    ax, ay = torch.abs(x), torch.abs(y)
    hi, lo = torch.maximum(ax, ay), torch.minimum(ax, ay)
    t = lo / torch.clamp(hi, min=1e-30)
    s = t * t
    r = t * (0.9999993329 + s * (-0.3332985605 + s * (0.1994653599 + s * (
        -0.1390853351 + s * (0.0964200441 + s * (
            -0.0559098861 + s * (0.0218612288 + s * -0.0040454090)))))))
    r = torch.where(ay > ax, 1.5707963267948966 - r, r)
    r = torch.where(x < 0, 3.141592653589793 - r, r)
    return torch.where(y < 0, -r, r)


# ------------------------------------------------------------ moving cloud

def moving_fields(mov, T: torch.Tensor, proj: PolarProjection) -> dict:
    """Transform moving lanes (x, y, nx, ny, valid) by pose T; beam
    assignment ``col_i`` (-1 where invalid) and gate ``okp``."""
    mx, my, mnx, mny, mv = mov
    c_, s_ = torch.cos(T[2]), torch.sin(T[2])
    px = c_ * mx - s_ * my + T[0]
    py = s_ * mx + c_ * my + T[1]
    nx = c_ * mnx - s_ * mny
    ny = s_ * mnx + c_ * mny
    d = torch.sqrt(px * px + py * py)
    colf = torch.floor(atan2_poly(py, px) * proj.f + proj.c)
    okp = ((mv > 0) & (colf >= 0) & (colf < proj.cols)
           & (d >= proj.range_min) & (d <= proj.range_max))
    col_i = torch.where(okp, colf, torch.full_like(colf, -1.0)).to(torch.int64)
    return dict(px=px, py=py, nx=nx, ny=ny, d=d, col_i=col_i, okp=okp)


def window_start(i: int, cols_padded: int, window: int = WINDOW) -> int:
    return min(max(i * 128 - (window - 128) // 2, 0), cols_padded - window)


def window_hot(f: dict, cols_padded: int, window: int = WINDOW) -> torch.Tensor:
    """The one-hot gather's band: lane r (block r // 128) matches the canvas
    column col_i[r] only while it lies in the block's window (the Pallas
    one-hot gather finds nothing outside it)."""
    col_i = f["col_i"]
    w0 = torch.tensor([window_start(i, cols_padded, window)
                       for i in range(col_i.shape[-1] // 128)],
                      device=col_i.device).repeat_interleave(128)
    local = col_i - w0
    return f["okp"] & (local >= 0) & (local < window)


def gather_canvas(canvas: torch.Tensor, f: dict, hot: torch.Tensor) -> torch.Tensor:
    """Canvas rows 0-5 at each lane's beam, zero where the lane is not hot
    (what the Pallas gathers return for an unmatched lane). canvas
    [8, ..., B] -> [6, ..., B]."""
    idx = torch.where(hot, f["col_i"], torch.zeros_like(f["col_i"]))
    return torch.gather(canvas[:6], -1, idx.expand((6,) + idx.shape)) * hot.to(_f())


def match_terms(gath: torch.Tensor, f: dict, point_distance: float, normal_cos: float,
                chi_threshold: float) -> torch.Tensor:
    """The 13 normal-equation terms per lane from gathered canvas cells
    [6, ..., B] -> [13, ..., B]: h00 h01 h02 h11 h12 h22 b0 b1 b2 n_ok
    chi_sum inl_chi inl_count."""
    bmin, bfx, bfy, bfnx, bfny, bhas = gath
    px_b, py_b, d_b, nx_b, ny_b = f["px"], f["py"], f["d"], f["nx"], f["ny"]

    close = torch.abs(bmin - d_b) <= point_distance
    ndot = bfnx * nx_b + bfny * ny_b
    ok = (bhas > 0.5) & close & (ndot >= normal_cos)
    e1 = bfnx * (px_b - bfx) + bfny * (py_b - bfy)
    e2 = nx_b - bfnx
    e3 = ny_b - bfny
    chi = e1 * e1 + e2 * e2 + e3 * e3
    if chi_threshold > 0:
        w = torch.where(chi < chi_threshold, torch.ones_like(chi),
                        chi_threshold / torch.clamp(chi, min=1e-20))
    else:
        w = torch.ones_like(chi)
    w = torch.where(ok, w, torch.zeros_like(w))
    okf = ok.to(_f())
    j1c = bfnx * (-py_b) + bfny * px_b
    sn2 = nx_b * nx_b + ny_b * ny_b
    thr = chi_threshold if chi_threshold > 0 else _BIG
    inl = okf * (chi < thr).to(_f())
    return torch.stack([
        w * bfnx * bfnx, w * bfnx * bfny, w * bfnx * j1c,
        w * bfny * bfny, w * bfny * j1c, w * (j1c * j1c + sn2),
        w * bfnx * e1, w * bfny * e1,
        w * (j1c * e1 - ny_b * e2 + nx_b * e3),
        okf, okf * chi, inl * chi, inl,
    ])


def banded_stats(canvas: torch.Tensor, f: dict, cols_padded: int,
                 point_distance: float, normal_cos: float, chi_threshold: float,
                 window: int = WINDOW) -> torch.Tensor:
    """Banded match of moving lanes [..., B] against the canvas [8, ..., B]
    and the normal-equation reduction -> [13, ...] sums, accumulated per
    128-lane block and then over the lanes (the Pallas order)."""
    terms = match_terms(gather_canvas(canvas, f, window_hot(f, cols_padded, window)), f,
                        point_distance, normal_cos, chi_threshold)
    acc = torch.zeros(terms.shape[:-1] + (128,), device=terms.device)
    for i in range(terms.shape[-1] // 128):
        acc = acc + terms[..., i * 128:(i + 1) * 128]
    return acc.sum(dim=-1)


def add_odom_prior(sums9, T, prior, odom_weight: float):
    """Geodesic odometry-prior factor added to the 9 normal-equation sums."""
    h00, h01, h02, h11, h12, h22, b0, b1, b2 = sums9
    ca, sa = torch.cos(-prior[2]), torch.sin(-prior[2])
    atx = -(torch.cos(prior[2]) * prior[0] + torch.sin(prior[2]) * prior[1])
    aty = -(-torch.sin(prior[2]) * prior[0] + torch.cos(prior[2]) * prior[1])
    ex = atx + ca * T[0] - sa * T[1]
    ey = aty + sa * T[0] + ca * T[1]
    et = T[2] - prior[2]
    jx2 = ca * -T[1] - sa * T[0]
    jy2 = sa * -T[1] + ca * T[0]
    h00 = h00 + odom_weight * (ca * ca + sa * sa)
    h02 = h02 + odom_weight * (ca * jx2 + sa * jy2)
    h11 = h11 + odom_weight * (ca * ca + sa * sa)
    h12 = h12 + odom_weight * (-sa * jx2 + ca * jy2)
    h22 = h22 + odom_weight * (jx2 * jx2 + jy2 * jy2 + 1.0)
    b0 = b0 + odom_weight * (ca * ex + sa * ey)
    b1 = b1 + odom_weight * (-sa * ex + ca * ey)
    b2 = b2 + odom_weight * (jx2 * ex + jy2 * ey + et)
    return h00, h01, h02, h11, h12, h22, b0, b1, b2


# ----------------------------------------------------------- lane utilities

def lane_prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over lanes."""
    return torch.cumsum(x, dim=-1)


def beam_zbuffer_by_shifts(vals: torch.Tensor, d: torch.Tensor,
                           col_i: torch.Tensor, okp: torch.Tensor,
                           max_shift: int):
    """Per-beam z-buffer of beam-indexed lanes: lane r targets beam
    col_i[r], counted only while |col_i - r| <= max_shift. The closest depth
    wins; on equal depths the HIGHEST source lane wins (the Pallas kernel
    enumerates shifts -max..+max with out[b] = x[b - s], and the first
    shift to win is the one from the highest lane). ``vals`` [V, ..., B] rows
    ride along to the winning beam; d, col_i and okp are [..., B] (leading
    dimensions batch independent streams). Returns (smin [..., B],
    svals [V, ..., B], s_ok)."""
    B = d.shape[-1]
    dev = d.device
    lane = torch.arange(B, device=dev).expand(d.shape)
    elig = okp & (torch.abs(col_i - lane) <= max_shift)
    tgt = torch.where(elig, col_i, torch.full_like(col_i, B))
    smin = torch.full(d.shape[:-1] + (B + 1,), _BIG, device=dev).scatter_reduce(
        -1, tgt, torch.where(elig, d, torch.full_like(d, _BIG)), "amin")[..., :B]
    s_ok = smin < _BIG
    hit = elig & (d <= torch.gather(smin, -1, col_i.clamp(0, B - 1)))
    win = torch.full(d.shape[:-1] + (B + 1,), -1, dtype=torch.int64,
                     device=dev).scatter_reduce(
        -1, torch.where(hit, tgt, torch.full_like(tgt, B)),
        torch.where(hit, lane, torch.full_like(lane, -1)), "amax")[..., :B]
    picked = torch.gather(vals, -1, win.clamp(min=0).expand(vals.shape))
    svals = torch.where(s_ok, picked, torch.zeros_like(vals))
    return smin, svals, s_ok


def merge_lanes(canvas: torch.Tensor, smin: torch.Tensor, svals: torch.Tensor,
                s_ok: torch.Tensor, count: torch.Tensor, merge_range: float,
                merge_threshold: float, cap: float) -> dict:
    """The lean merge decision per beam: the measurement canvas [8, ..., B]
    against the z-buffered scene cells (``beam_zbuffer_by_shifts`` of the
    rows px, py, nx, ny, scene row). A beam merges with its cell (depths
    within ``merge_threshold``; the two are averaged), replaces it (the cell
    is closer), or appends at the next free scene row after ``count``
    (broadcastable to the lanes) below ``cap``. Returns the masks ``m_ok``,
    ``modify``, ``do_append`` and ``app_ok``, the beam's point ``upd`` (px,
    py, nx, ny; sensor frame), its payload ``target`` row and ``kind`` (0
    none / 1 modify / 2 append), and the post-merge visible cell per beam
    ``cache`` (x, y, nx, ny, valid, scene row)."""
    spx, spy, snx, sny, srow = svals
    fmin, bfx, bfy, bfnx, bfny, fhas = canvas[:6]
    m_ok = (fhas > 0.5) & (fmin <= merge_range)
    dr = fmin - smin
    both = m_ok & s_ok
    do_merge = both & (torch.abs(dr) < merge_threshold)
    do_replace = both & ~do_merge & (dr > 0)
    do_append = (m_ok & ~s_ok) | (both & ~do_merge & ~do_replace)
    modify = do_merge | do_replace

    avg_px, avg_py = 0.5 * (spx + bfx), 0.5 * (spy + bfy)
    avg_nx, avg_ny = 0.5 * (snx + bfnx), 0.5 * (sny + bfny)
    nrm = torch.clamp(torch.sqrt(avg_nx * avg_nx + avg_ny * avg_ny), min=1e-12)
    avg_nx, avg_ny = avg_nx / nrm, avg_ny / nrm
    upd_px = torch.where(do_merge, avg_px, bfx)
    upd_py = torch.where(do_merge, avg_py, bfy)
    upd_nx = torch.where(do_merge, avg_nx, bfnx)
    upd_ny = torch.where(do_merge, avg_ny, bfny)

    neg1 = torch.full_like(fmin, -1.0)
    slot = count + lane_prefix_sum(do_append.to(_f())) - 1.0
    app_ok = do_append & (slot < cap)
    target = torch.where(modify, srow, torch.where(app_ok, slot, neg1))
    kind = torch.where(modify, 1.0, torch.where(app_ok, 2.0, 0.0))

    nrow = torch.where(modify, srow, torch.where(
        app_ok, slot, torch.where(s_ok & ~m_ok, srow, neg1)))
    nvalid = ((m_ok | s_ok) & (nrow >= 0)).to(_f())
    cache = (torch.where(m_ok, upd_px, spx), torch.where(m_ok, upd_py, spy),
             torch.where(m_ok, upd_nx, snx), torch.where(m_ok, upd_ny, sny), nvalid, nrow)
    return dict(m_ok=m_ok, modify=modify, do_append=do_append, app_ok=app_ok,
                upd=(upd_px, upd_py, upd_nx, upd_ny), target=target, kind=kind, cache=cache)
