"""A frozen copy of the plain K-stream frame step of the port
(``_frame_body_b_plain`` of ``ops/stream_kernel.py``, kernel 3's plain
version) and of the scene materialization (``models/fast_tracker.py:
materialize``), as the benchmark was written. The fleet cells' reference.

Plain PyTorch; floating tensors take the default dtype (``_f()``), so the
control runs it in bfloat16.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import beam, prep
from .prep import PolarProjection


def _f() -> torch.dtype:
    return torch.get_default_dtype()


@dataclass(frozen=True)
class Spec:
    """The frame step's settings (the port's ``FrameSpec`` fields)."""

    projection: PolarProjection
    scene_capacity: int
    iterations: int
    point_distance: float
    normal_cos: float
    chi_threshold: float
    min_inliers: int
    odom_weight: float
    merge_threshold: float
    merge_shift: int
    window: int
    stream_gather: str
    stream_band_shift: int
    corr_refresh: int
    split_distance: float = 0.0

    @property
    def cols_padded(self) -> int:
        c = self.projection.cols
        return max(((c + 127) // 128) * 128, self.window)


def _pose3(block: torch.Tensor, lo: int) -> torch.Tensor:
    """Lanes lo:lo+3 of a [K, n] block as a [3, K, 1] pose, whose entries
    broadcast against [K, B] rows (what the ``bk`` SE(2) helpers index)."""
    return block[:, lo:lo + 3].t().unsqueeze(-1)


def _roll_hot(f, spec: Spec):
    """The shift enumeration's band: the beam lies within
    ``stream_band_shift`` of the lane; no block window."""
    lane = torch.arange(spec.cols_padded, device=f["col_i"].device)
    return f["okp"] & (torch.abs(f["col_i"] - lane) <= spec.stream_band_shift)


def _stats_from_gather_b(gath, f, spec: Spec) -> torch.Tensor:
    """Whole-row sums of the 13 terms, [13, K, 1]."""
    return beam.match_terms(gath, f, spec.point_distance, spec.normal_cos,
                          spec.chi_threshold).sum(dim=-1, keepdim=True)


def _frame_body_b_plain(spec: Spec, measC, cacheB, poseB, odomB):
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
    D = torch.where(use_prior, beam.relative_s(last_odom, odom), torch.zeros_like(odom))
    T0 = beam.inverse_s(beam.compose_s(D, S))

    # moving cloud = cache cells re-framed prev-sensor -> prev-robot
    cS, sS = torch.cos(S[2]), torch.sin(S[2])
    cx, cy, cnx, cny, cval, crow = cacheB[:6]
    mov = (cS * cx - sS * cy + S[0], sS * cx + cS * cy + S[1],
           cS * cnx - sS * cny, sS * cnx + cS * cny, cval)

    if spec.stream_gather == "roll":
        def gather_of(f):
            return beam.gather_canvas(measC, f, _roll_hot(f, spec))

        def stats_of(f):
            return _stats_from_gather_b(gather_of(f), f, spec)
    else:
        def gather_of(f):
            return beam.gather_canvas(measC, f, beam.window_hot(f, B, spec.window))

        def stats_of(f):
            # per-128-lane-block partials, then the lane sum (the Pallas order)
            return beam.banded_stats(measC, f, B, spec.point_distance, spec.normal_cos,
                                   spec.chi_threshold, window=spec.window).unsqueeze(-1)

    it_lane = torch.arange(B, device=dev).expand(K, B)

    def solve_update(s, T, iter_row, step):
        iter_row = torch.where(it_lane == step, s[10], iter_row)
        iter_row = torch.where(it_lane == 64 + step, s[12], iter_row)
        sums9 = tuple(s[k] for k in range(9))
        if spec.odom_weight > 0:
            sums9 = beam.add_odom_prior(sums9, T, T0, spec.odom_weight)
        h00, h01, h02, h11, h12, h22, b0, b1, b2 = sums9
        dx = beam.solve3_sym(h00, h01, h02, h11, h12, h22, -b0, -b1, -b2, 1e-20)
        guard = s[9] >= spec.min_inliers
        dx = torch.stack([torch.where(guard, v, torch.zeros_like(v)) for v in dx])
        return beam.compose_s(dx, T), iter_row

    T = T0
    iter_row = torch.zeros(K, B, device=dev)
    refresh = max(int(spec.corr_refresh), 1)
    if refresh == 1:
        for i in range(spec.iterations):
            s = stats_of(beam.moving_fields(mov, T, proj))
            T, iter_row = solve_update(s, T, iter_row, i)
    else:
        # one gather per outer step feeds `refresh` updates on frozen cells;
        # updates past `iterations` are masked in the Pallas loop, so they
        # are not run here
        for i in range(-(-spec.iterations // refresh)):
            f = beam.moving_fields(mov, T, proj)
            g = gather_of(f)
            for sub in range(refresh):
                step = i * refresh + sub
                if step >= spec.iterations:
                    break
                if sub > 0:
                    f = beam.moving_fields(mov, T, proj)
                T, iter_row = solve_update(_stats_from_gather_b(g, f, spec), T,
                                           iter_row, step)

    # final fields: stats and the transformed cache (current sensor frame)
    f = beam.moving_fields(mov, T, proj)
    s = stats_of(f)

    # ---- merge (beam-window lean semantics) ----
    vals = torch.stack([f["px"], f["py"], f["nx"], f["ny"], crow])
    smin, svals, s_ok = beam.beam_zbuffer_by_shifts(
        vals, f["d"], f["col_i"], f["okp"] & (crow >= 0), spec.merge_shift)
    # appends take scene rows on from the carried per-stream count
    mg = beam.merge_lanes(measC, smin, svals, s_ok, count, 0.9 * proj.range_max,
                        spec.merge_threshold, cap)
    upd_px, upd_py, upd_nx, upd_ny = mg["upd"]
    n_app = mg["do_append"].to(_f()).sum(dim=-1, keepdim=True)

    # new robot pose and the payload in the scene (local-map) frame
    X_new = beam.compose_s(X_old, beam.inverse_s(beam.compose_s(S, T)))
    M = beam.compose_s(X_new, S)
    cM, sM = torch.cos(M[2]), torch.sin(M[2])
    pay_x = cM * upd_px - sM * upd_py + M[0]
    pay_y = sM * upd_px + cM * upd_py + M[1]
    pay_nx = cM * upd_nx - sM * upd_ny
    pay_ny = sM * upd_nx + cM * upd_ny

    n_app_ok = mg["app_ok"].to(_f()).sum(dim=-1, keepdim=True)
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


def track_streams(spec: Spec, cacheB, poseB, measC_stack, odom_stack):
    """T frames in order, all K streams at once on [K, B] rows:
    measC_stack [T, 8, K, B], odom_stack [T, K, 8] -> (cacheB', poseB',
    payloads [T, 8, K, B])."""
    payloads = []
    for t in range(measC_stack.shape[0]):
        cacheB, poseB, pay = _frame_body_b_plain(spec, measC_stack[t], cacheB, poseB,
                                                 odom_stack[t])
        payloads.append(pay)
    return cacheB, poseB, torch.stack(payloads)


def materialize(spec: Spec, scene: prep.Cloud, payloads: torch.Tensor,
                final_count) -> prep.Cloud:
    """Fold [..., T, 8, B] payloads into scenes [..., cap, ...]: for each
    scene row the last write (highest frame, then highest lane) wins; the
    first ``final_count`` rows are valid. Leading dimensions batch scenes."""
    lead = payloads.shape[:-3]
    T, _, B = payloads.shape[-3:]
    cap = spec.scene_capacity
    dev = payloads.device
    P = payloads.reshape((-1, T, 8, B))
    S_ = P.shape[0]
    rows = P[:, :, 4, :].to(torch.int64).reshape(S_, T * B)
    kind = P[:, :, 5, :].reshape(S_, T * B)
    live = (kind > 0) & (rows >= 0) & (rows < cap)
    flat = torch.arange(T * B, device=dev).expand(S_, -1)
    win = torch.full((S_, cap + 1), -1, dtype=torch.int64, device=dev).scatter_reduce(
        1, torch.where(live, rows, torch.full_like(rows, cap)),
        torch.where(live, flat, torch.full_like(flat, -1)), "amax")[:, :cap]
    has = (win >= 0)[..., None]
    vals = P[:, :, 0:4, :].permute(0, 1, 3, 2).reshape(S_, T * B, 4)
    picked = torch.gather(vals, 1, win.clamp(min=0)[..., None].expand(S_, cap, 4))
    xy0 = scene.xy.reshape(S_, cap, 2)
    nm0 = scene.normal.reshape(S_, cap, 2)
    xy = torch.where(has, picked[..., 0:2], xy0)
    nm = torch.where(has, picked[..., 2:4], nm0)
    counts = torch.as_tensor(final_count, device=dev).to(torch.int64).reshape(S_, 1)
    valid = torch.arange(cap, device=dev) < counts
    return prep.Cloud(xy.reshape(lead + (cap, 2)), nm.reshape(lead + (cap, 2)),
                 valid.reshape(lead + (cap,)))
