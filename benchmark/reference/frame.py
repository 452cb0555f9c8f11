"""A frozen copy of the plain single-stream frame step of the port
(``_frame_body_plain`` of ``ops/frame_kernel.py``, kernel 1's plain
version, canvas layout, with the in-kernel local-map split), as the
benchmark was written. The corridor cell's reference for kernel 1.

Plain PyTorch; floating tensors take the default dtype (``_f()``).
"""

from __future__ import annotations

import torch

from . import beam
from .stream import Spec


def _f() -> torch.dtype:
    return torch.get_default_dtype()


def _frame_body_plain(spec: Spec, measF, cacheT, pose):
    """One frame. measF [8, B] canvas or [F, 8] raw rows (spec's layout),
    cacheT [8, B], pose [2, 8] -> (cacheT', pose', payload [8, B])."""
    proj = spec.projection
    B = spec.cols_padded
    canvasT, odomF = measF, measF[6, 0:4]
    cap = float(spec.scene_capacity)
    dev = canvasT.device
    zero3 = torch.zeros(3, device=dev)

    X_old, last_odom = pose[0, 0:3], pose[0, 3:6]
    has_odom, count = pose[0, 6], pose[0, 7]
    S = pose[1, 0:3]
    odom, ov = odomF[0:3], odomF[3]

    use_prior = (has_odom > 0) & (ov > 0)
    D = torch.where(use_prior, beam.relative_s(last_odom, odom), zero3)
    T0 = beam.inverse_s(beam.compose_s(D, S))

    cS, sS = torch.cos(S[2]), torch.sin(S[2])
    cx, cy, cnx, cny, cval, crow = cacheT[0], cacheT[1], cacheT[2], cacheT[3], cacheT[4], cacheT[5]
    mov = (cS * cx - sS * cy + S[0], sS * cx + cS * cy + S[1],
           cS * cnx - sS * cny, sS * cnx + cS * cny, cval)

    lane = torch.arange(B, device=dev)
    iter_row = torch.zeros(B, device=dev)
    T = T0
    for i in range(spec.iterations):
        s = beam.banded_stats(canvasT, beam.moving_fields(mov, T, proj), B,
                            spec.point_distance, spec.normal_cos,
                            spec.chi_threshold, window=spec.window)
        iter_row = torch.where(lane == i, s[10], iter_row)
        iter_row = torch.where(lane == 64 + i, s[12], iter_row)
        sums9 = tuple(s[k] for k in range(9))
        if spec.odom_weight > 0:
            sums9 = beam.add_odom_prior(sums9, T, T0, spec.odom_weight)
        h00, h01, h02, h11, h12, h22, b0, b1, b2 = sums9
        dx = beam.solve3_sym(h00, h01, h02, h11, h12, h22, -b0, -b1, -b2, 1e-20)
        guard = s[9] >= spec.min_inliers
        dx = torch.stack([torch.where(guard, v, torch.zeros_like(v)) for v in dx])
        T = beam.compose_s(dx, T)

    f = beam.moving_fields(mov, T, proj)
    s = beam.banded_stats(canvasT, f, B, spec.point_distance, spec.normal_cos,
                        spec.chi_threshold, window=spec.window)

    # ---- merge (beam-window lean semantics) ----
    vals = torch.stack([f["px"], f["py"], f["nx"], f["ny"], crow])
    smin, svals, s_ok = beam.beam_zbuffer_by_shifts(
        vals, f["d"], f["col_i"], f["okp"] & (crow >= 0), spec.merge_shift)
    mg = beam.merge_lanes(canvasT, smin, svals, s_ok, count, 0.9 * proj.range_max,
                        spec.merge_threshold, cap)
    m_ok, app_ok, target, kind = mg["m_ok"], mg["app_ok"], mg["target"], mg["kind"]
    upd_px, upd_py, upd_nx, upd_ny = mg["upd"]
    ncx, ncy, nnx, nny, nvalid, nrow = mg["cache"]
    n_app = mg["do_append"].to(_f()).sum()

    X_new = beam.compose_s(X_old, beam.inverse_s(beam.compose_s(S, T)))
    M = beam.compose_s(X_new, S)
    cM, sM = torch.cos(M[2]), torch.sin(M[2])
    pay_x = cM * upd_px - sM * upd_py + M[0]
    pay_y = sM * upd_px + cM * upd_py + M[1]
    pay_nx = cM * upd_nx - sM * upd_ny
    pay_ny = sM * upd_nx + cM * upd_ny
    count_new = torch.clamp(count + n_app, max=cap)

    do_split = torch.zeros((), device=dev)
    if spec.split_distance > 0:
        do_split = (torch.sqrt(X_new[0] * X_new[0] + X_new[1] * X_new[1])
                     >= spec.split_distance).to(_f())
        bfx, bfy, bfnx, bfny = canvasT[1], canvasT[2], canvasT[3], canvasT[4]
        seedf = m_ok.to(_f())
        seed_slot = beam.lane_prefix_sum(seedf) - 1.0   # not capped (as in Pallas)
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
        T, torch.stack([s[10], s[9], s[12], app_ok.to(_f()).sum(),
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


def track_frames(spec: Spec, cacheT, pose, measC):
    """T frames in order: cacheT [8, B], pose [2, 8], measC [T, 8, B]
    canvases with the odometry in row 6 -> (cacheT', pose', payloads
    [T, 8, B])."""
    payloads = []
    for t in range(measC.shape[0]):
        cacheT, pose, pay = _frame_body_plain(spec, measC[t], cacheT, pose)
        payloads.append(pay)
    return cacheT, pose, torch.stack(payloads)
