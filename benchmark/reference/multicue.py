"""A frozen copy of the multi-cue tracking step of the port's MULTI assembly
(``models/tracker.track_step_multi`` with ``use_fused_aligner``): each cue's
projective clip of the local-map scene, kernel 6's alignment
(``ops/multicue_align_kernel.fused_projective_align_multi_plain`` and the
``_beam_kernels`` helpers it calls), each cue's projective merge
(``ops/clip.clip_projective``, ``ops/merge.merge_projective``,
``utils/cloud.concat``), as the benchmark was written.

Plain PyTorch, float32 unless ``precision.computed_in`` says otherwise:
every floating tensor made here takes the default dtype, so the control
runs the same step in bfloat16. The beam-space arithmetic is ``beam.py``'s,
the projection and the clouds ``prep.py``'s. The port may change; this copy
may not.

Where the alignment departs from the reference's ``MultiAligner2D``
(srrg2_laser_slam_2d), as the port's kernel 6 does:

- a fixed 10 Gauss-Newton passes (``iterations``) and one pass for the
  final statistics, with no epsilon exit;
- each cue's measurement is z-buffered once into a canvas whose cell holds
  the closest depth and the mean of the points tied at it;
- every moving row matches its cue's canvas at its beam (dense, no band and
  no moving-side z-buffer), its beam found with the polynomial arctangent
  (``beam.atan2_poly``), not ``atan2``;
- an update is taken only with ``min_inliers`` inliers and
  ``max(min_corr, 1)`` correspondences.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import beam, prep
from .prep import Cloud, PolarProjection

_BIG = 1.0e30


def _f() -> torch.dtype:
    return torch.get_default_dtype()


def cols_padded(proj: PolarProjection) -> int:
    return ((proj.cols + 127) // 128) * 128


class State(NamedTuple):
    """What one step reads of the tracker: the scene (local-map frame), the
    robot in the local map, the last odometry and whether there was one."""

    scene: Cloud
    robot_in_local_map: torch.Tensor
    last_odom: torch.Tensor
    has_odom: torch.Tensor


class Aligned(NamedTuple):
    estimate: torch.Tensor      # [3] previous robot -> current robot
    chi: torch.Tensor
    num_corr: torch.Tensor
    num_inliers: torch.Tensor
    chi_inl_sum: torch.Tensor
    iter_stats: torch.Tensor    # [iterations, 4]: chi, correspondences, inliers, inlier chi


# ------------------------------------------------------------ the canvas

def build_canvas(x, y, nx, ny, v, B: int, proj: PolarProjection) -> torch.Tensor:
    """Clouds' [..., N] fields (sensor frame) z-buffered at identity ->
    canvases [8, ..., B]: per beam the closest depth (1e30 where empty), the
    mean of the points tied at it, has-point."""
    d = torch.sqrt(x * x + y * y)
    colf = torch.floor(beam.atan2_poly(y, x) * proj.f + proj.c)
    ok = ((v > 0) & (colf >= 0) & (colf < proj.cols)
          & (d >= proj.range_min) & (d <= proj.range_max))
    col = torch.where(ok, colf, torch.full_like(colf, B)).to(torch.int64)
    empty = torch.full(d.shape[:-1] + (B + 1,), _BIG, device=d.device)
    dmin = empty.scatter_reduce(-1, col, torch.where(ok, d, torch.full_like(d, _BIG)), "amin")
    w = (ok & (d <= torch.gather(dmin, -1, col))).to(_f())
    zero = torch.zeros_like(empty)
    cnt = zero.scatter_add(-1, col, w)
    inv = 1.0 / torch.clamp(cnt, min=1.0)
    means = [zero.scatter_add(-1, col, f * w) * inv for f in (x, y, nx, ny)]
    has = (cnt > 0).to(_f())
    return torch.stack([dmin, *means, has, zero, zero])[..., :B]


# --------------------------------------------------------- the alignment

def remap_sums9(sums9, a00, a01, a02, a10, a11, a12):
    """H -> A^T H A, b -> A^T b on the 9 unique normal-equation sums."""
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
    """[C, 8] per cue: inverse(e_c), then the translation column of A_c."""
    e = extrinsics.to(_f())
    ce, se = torch.cos(e[:, 2]), torch.sin(e[:, 2])
    out = torch.zeros(e.shape[0], 8, device=e.device)
    out[:, 0:3] = prep.inverse(e)
    out[:, 3] = ce * (-e[:, 1]) + se * e[:, 0]
    out[:, 4] = -se * (-e[:, 1]) + ce * e[:, 0]
    return out


def align_multi(proj: PolarProjection, fixed_xy, fixed_normal, fixed_valid, extrinsics,
                moving_xy, moving_normal, moving_valid, initial, odom_prior=None,
                iterations=10, point_distance=0.5, normal_cos=0.8, chi_threshold=0.05,
                min_inliers=10, min_corr=1, odom_weight=0.0, damping=0.0) -> Aligned:
    """Kernel 6's arithmetic for one frame or a batch of L frames: fixed
    [(L,) C, N, ...] per-cue clouds in their sensor frames, extrinsics
    [C, 3] (shared), moving [(L,) M, ...] in the previous robot frame,
    initial and prior [(L,) 3]; the cues are one more batch axis of the
    moving cloud's match. The fields of the result carry the batch axis
    last but one in ``iter_stats`` ([(L,) iterations, 4]) and first
    elsewhere (``estimate`` [(L,) 3])."""
    B = cols_padded(proj)
    cue = cue_constants(extrinsics)
    canvases = build_canvas(fixed_xy[..., 0], fixed_xy[..., 1], fixed_normal[..., 0],
                            fixed_normal[..., 1], fixed_valid, B, proj)   # [8, (L,) C, B]
    pad = -moving_xy.shape[-2] % 128
    mov = tuple(torch.nn.functional.pad(x.to(_f()), (0, pad))[..., None, :] for x in (
        moving_xy[..., 0], moving_xy[..., 1], moving_normal[..., 0], moving_normal[..., 1],
        moving_valid))                                                    # [(L,) 1, M]
    inv_e = cue[:, 0:3].T[..., None]                                      # [3, C, 1]
    ci, si = torch.cos(cue[:, 2]), torch.sin(cue[:, 2])
    remap = (ci, -si, cue[:, 3], si, ci, cue[:, 4])

    def stats_of(T):                                                      # T [3, (L)]
        f = beam.moving_fields(mov, beam.compose_s(inv_e, T[..., None, None]), proj)
        s = beam.banded_stats(canvases, f, B, point_distance, normal_cos, chi_threshold,
                              window=B)                                   # [13, (L,) C]
        r9 = remap_sums9(tuple(s[k] for k in range(9)), *remap)
        return [v.sum(-1) for v in r9] + [s[k].sum(-1) for k in range(9, 13)]

    T = initial.to(_f()).movedim(-1, 0)
    prior = (initial if odom_prior is None else odom_prior).to(_f()).movedim(-1, 0)
    records = []
    for _ in range(iterations):
        s = stats_of(T)
        records.append(torch.stack([s[10], s[9], s[12], s[11]], -1))
        sums9 = tuple(s[:9])
        if odom_weight > 0:
            sums9 = beam.add_odom_prior(sums9, T, prior, odom_weight)
        h00, h01, h02, h11, h12, h22, b0, b1, b2 = sums9
        dx = beam.solve3_sym(h00 + damping, h01, h02, h11 + damping, h12, h22 + damping,
                             -b0, -b1, -b2, 1e-20)
        guard = (s[12] >= min_inliers) & (s[9] >= max(min_corr, 1))
        T = beam.compose_s(torch.stack([torch.where(guard, v, torch.zeros_like(v))
                                        for v in dx]), T)
    s = stats_of(T)
    iters = (torch.stack(records, -2) if records
             else torch.zeros(T.shape[1:] + (0, 4), device=T.device))
    return Aligned(T.movedim(0, -1), s[10], s[9], s[12], s[11], iters)


# ------------------------------------------------------ clip and merge

def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + (x.shape[-1],)))


def relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return prep.compose(prep.inverse(a), b)


def clip_projective(proj: PolarProjection, scene: Cloud, robot_in_local_map: torch.Tensor,
                    sensor_in_robot: torch.Tensor) -> Cloud:
    """The z-buffer-visible cell of every beam of the scene seen from the
    sensor, in the robot frame; one row per beam."""
    (_, idx, valid), local = prep.project(
        proj, prep.compose(robot_in_local_map, sensor_in_robot), scene)
    idx = torch.clamp(idx, min=0)
    return prep.transform(Cloud(_take(local.xy, idx), _take(local.normal, idx), valid),
                          sensor_in_robot)


def _scatter_rows(values: torch.Tensor, dest: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(values.shape[:-2] + (n + 1, values.shape[-1]), dtype=values.dtype,
                      device=values.device)
    return out.scatter(-2, dest[..., None].expand(values.shape), values)[..., :n, :]


def concat(a: Cloud, b: Cloud) -> Cloud:
    """The valid points of ``a`` then those of ``b``, compacted into both
    capacities."""
    a, b = prep.compact(a), prep.compact(b)
    cap = a.xy.shape[0] + b.xy.shape[0]
    na, nb = a.valid.sum(), b.valid.sum()
    dev = a.xy.device
    dest = torch.cat([torch.where(a.valid, torch.arange(a.xy.shape[0], device=dev), cap),
                      torch.where(b.valid, na + torch.arange(b.xy.shape[0], device=dev), cap)])
    dest = torch.clamp(dest, max=cap)
    valid = torch.arange(cap, device=dev) < torch.clamp(na + nb, max=cap)
    return Cloud(_scatter_rows(torch.cat([a.xy, b.xy]), dest, cap),
                 _scatter_rows(torch.cat([a.normal, b.normal]), dest, cap), valid)


def _unit_mean(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    avg = 0.5 * (a + b)
    return avg / torch.clamp(torch.linalg.norm(avg, dim=-1, keepdim=True), min=1e-12)


def _put_rows(x: torch.Tensor, dest: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """x [cap, 2] with rows ``dest`` set to ``vals``; ``dest == cap`` drops."""
    ext = torch.cat([x, x.new_zeros(1, 2)])
    ext[dest] = vals
    return ext[:x.shape[0]]


def merge_projective(proj: PolarProjection, scene: Cloud, measurement: Cloud,
                     measurement_in_scene: torch.Tensor, merge_threshold: float) -> Cloud:
    """Fuse a measurement (its own frame) into the scene, beam by beam of
    the canvas seen from the measurement's pose: a cell beyond 0.9
    range_max is dropped; an empty scene cell appends; depths within
    ``merge_threshold`` average; a measurement behind the scene point
    replaces it; one in front of it appends."""
    cam = measurement_in_scene
    (s_depth, s_idx, s_ok), _ = prep.project(proj, cam, scene)
    meas = prep.transform(measurement, cam)
    (m_depth, m_idx, m_valid), _ = prep.project(proj, cam, meas)
    m_ok = m_valid & (m_depth <= 0.9 * proj.range_max)
    m_idx, s_idx = torch.clamp(m_idx, min=0), torch.clamp(s_idx, min=0)
    dr = m_depth - s_depth
    both = m_ok & s_ok
    do_merge = both & (torch.abs(dr) < merge_threshold)
    do_replace = both & ~do_merge & (dr > 0)
    do_append = (m_ok & ~s_ok) | (both & ~do_merge & ~do_replace)

    mp, mn = meas.xy[m_idx], meas.normal[m_idx]
    cap = scene.xy.shape[0]
    full = torch.full_like(s_idx, cap)
    xy = _put_rows(scene.xy, torch.where(do_merge, s_idx, full), 0.5 * (scene.xy[s_idx] + mp))
    nm = _put_rows(scene.normal, torch.where(do_merge, s_idx, full),
                   _unit_mean(scene.normal[s_idx], mn))
    xy = _put_rows(xy, torch.where(do_replace, s_idx, full), mp)
    nm = _put_rows(nm, torch.where(do_replace, s_idx, full), mn)
    count = scene.valid.sum()
    slot = count + torch.cumsum(do_append.to(torch.int64), 0) - 1
    dest = torch.where(do_append & (slot < cap), slot, full)
    xy, nm = _put_rows(xy, dest, mp), _put_rows(nm, dest, mn)
    valid = torch.arange(cap, device=xy.device) < torch.clamp(count + do_append.sum(), max=cap)
    return Cloud(xy, nm, valid)


# ------------------------------------------------------------ one step

def step(proj: PolarProjection, aligner: dict, merge_threshold: float, state: State,
         measurements: Cloud, extrinsics: torch.Tensor, odom: torch.Tensor,
         odom_valid: torch.Tensor) -> tuple[Cloud, torch.Tensor]:
    """One multi-cue tracking step from ``state``: measurements [C, N, ...]
    in their sensor frames, extrinsics [C, 3]. ``aligner`` holds the
    keyword arguments of ``align_multi``. Returns the new scene and the new
    robot in the local map."""
    use_prior = state.has_odom & odom_valid
    D = torch.where(use_prior, relative(state.last_odom, odom),
                    torch.zeros_like(state.last_odom))
    clips = [clip_projective(proj, state.scene, state.robot_in_local_map, extrinsics[c])
             for c in range(extrinsics.shape[0])]
    moving = functools.reduce(concat, clips)
    T0 = prep.inverse(D)
    res = align_multi(proj, measurements.xy, measurements.normal, measurements.valid,
                      extrinsics, moving.xy, moving.normal, moving.valid, T0, odom_prior=T0,
                      **aligner)
    X_new = prep.compose(state.robot_in_local_map, prep.inverse(res.estimate))
    scene = state.scene
    for c in range(extrinsics.shape[0]):
        scene = merge_projective(proj, scene, measurements.map(lambda x: x[c]),
                                 prep.compose(X_new, extrinsics[c]), merge_threshold)
    return scene, X_new
