"""Map fusion in plain PyTorch. Counterpart of
``srrg2_laser_slam_2d_tpu/ops/merge.py``: ``merge_correspondence`` (the
closure-time MergerCorrespondencePointNormal2f, batched over pairs) and the
per-frame projective mergers ``merge_projective`` (MergerProjective2D) and
``merge_projective_lean`` (the scene side taken from the cached canvas).
``ops/scene_kernel.merge_projective`` is the kernel route of the former.
"""

from __future__ import annotations

import torch

from ..utils import geometry
from ..utils.cloud import Cloud
from . import projector as projector_op
from .projector import PolarProjection


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + (x.shape[-1],)))


def _set_rows(x: torch.Tensor, dest: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """x [J, cap, 2] with rows dest [J, K] set to vals [J, K, 2]; dest ==
    cap drops the row."""
    J, cap, _ = x.shape
    ext = torch.cat([x, x.new_zeros(J, 1, 2)], dim=1)
    return ext.scatter(1, dest[..., None].expand(vals.shape), vals)[:, :cap]


def merge_correspondence(scene: Cloud, moving: Cloud, fixed_idx: torch.Tensor,
                         moving_idx: torch.Tensor, corr_valid: torch.Tensor,
                         moving_in_scene: torch.Tensor,
                         maximum_distance_geometry_squared: float = 0.25,
                         target_number_of_merges: int = 200,
                         enable_binning: bool = True,
                         binning_resolution: float = 0.25) -> Cloud:
    """Batched over a leading pair dimension J: scene [J, cap, ...], moving
    [J, N, ...], correspondences [J, cols], moving_in_scene [J, 3].

    Corresponding pairs within the squared distance bound are averaged
    (normals renormalized); unclaimed moving points append, one per coarse
    grid cell when binning (first in cell order wins), at most
    ``target_number_of_merges``, into the free tail of the (compact) scene."""
    J, cap = scene.xy.shape[0], scene.capacity
    n_mov = moving.capacity
    dev = scene.xy.device
    mov = Cloud(
        xy=geometry.transform_points(moving_in_scene, moving.xy),
        normal=geometry.rotate_vectors(moving_in_scene, moving.normal),
        valid=moving.valid,
    )
    m_idx = torch.clamp(moving_idx, min=0)
    f_idx = torch.clamp(fixed_idx, min=0)
    mp, mn = _take(mov.xy, m_idx), _take(mov.normal, m_idx)
    sp, sn = _take(scene.xy, f_idx), _take(scene.normal, f_idx)
    d2 = ((mp - sp) ** 2).sum(-1)
    do_merge = corr_valid & (d2 <= maximum_distance_geometry_squared)

    avg_p = 0.5 * (sp + mp)
    avg_n = 0.5 * (sn + mn)
    nrm = torch.linalg.norm(avg_n, dim=-1, keepdim=True)
    avg_n = avg_n / torch.clamp(nrm, min=1e-12)
    tgt = torch.where(do_merge, f_idx, torch.full_like(f_idx, cap))
    xy = _set_rows(scene.xy, tgt, avg_p)
    nm = _set_rows(scene.normal, tgt, avg_n)

    claim_at = torch.where(do_merge, m_idx, torch.full_like(m_idx, n_mov))
    claimed = torch.zeros(J, n_mov + 1, dtype=torch.bool, device=dev).scatter(
        1, claim_at, True)[:, :n_mov]
    cand = mov.valid & ~claimed
    if enable_binning:
        cell = (torch.floor(mov.xy[..., 0] / binning_resolution).to(torch.int32) * 8192
                + torch.floor(mov.xy[..., 1] / binning_resolution).to(torch.int32))
        key = torch.where(cand, cell, torch.full_like(cell, 2**31 - 1))
        order = torch.argsort(key, dim=1, stable=True)
        sorted_cell = torch.gather(cell, 1, order)
        sorted_cand = torch.gather(cand, 1, order)
        first = torch.cat([torch.ones(J, 1, dtype=torch.bool, device=dev),
                           sorted_cell[:, 1:] != sorted_cell[:, :-1]], dim=1)
        cand = torch.zeros_like(cand).scatter(1, order, sorted_cand & first)
    rank = torch.cumsum(cand.to(torch.int64), dim=1) - 1
    cand = cand & (rank < target_number_of_merges)

    count = scene.valid.sum(dim=1, keepdim=True)
    slot = count + torch.cumsum(cand.to(torch.int64), dim=1) - 1
    dest = torch.where(cand & (slot < cap), slot, torch.full_like(slot, cap))
    xy = _set_rows(xy, dest, mov.xy)
    nm = _set_rows(nm, dest, mov.normal)
    new_count = torch.clamp(count + cand.sum(dim=1, keepdim=True), max=cap)
    valid = torch.arange(cap, device=dev) < new_count
    return Cloud(xy=xy, normal=nm, valid=valid)


def _beam_decisions(m_depth, m_ok, s_depth, s_ok, merge_threshold: float):
    """Per beam: merge (depths within the threshold), replace (the
    measurement lies behind the scene cell) or append."""
    dr = m_depth - s_depth
    both = m_ok & s_ok
    do_merge = both & (torch.abs(dr) < merge_threshold)
    do_replace = both & ~do_merge & (dr > 0)
    do_append = (m_ok & ~s_ok) | (both & ~do_merge & ~do_replace)
    return do_merge, do_replace, do_append


def _unit_mean(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    avg = 0.5 * (a + b)
    return avg / torch.clamp(torch.linalg.norm(avg, dim=-1, keepdim=True), min=1e-12)


def _put_rows(x: torch.Tensor, dest: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """x [cap, 2] with rows ``dest`` set to ``vals``; ``dest == cap`` drops."""
    cap = x.shape[0]
    ext = torch.cat([x, x.new_zeros(1, 2)])
    ext[dest] = vals
    return ext[:cap]


def _append_tail(xy, nm, valid, do_append, mp, mn):
    """Place appended points into the free tail of the compact scene.
    Returns (xy, nm, valid, slot per beam, dropped count)."""
    cap = xy.shape[0]
    count = valid.sum()
    slot = count + torch.cumsum(do_append.to(torch.int64), 0) - 1
    dest = torch.where(do_append & (slot < cap), slot, torch.full_like(slot, cap))
    xy, nm = _put_rows(xy, dest, mp), _put_rows(nm, dest, mn)
    new_count = torch.clamp(count + do_append.sum(), max=cap)
    dropped = (do_append & (slot >= cap)).sum()
    return xy, nm, torch.arange(cap, device=xy.device) < new_count, slot, dropped


def merge_projective_lean(proj: PolarProjection, scene: Cloud, cache_cells: Cloud,
                          cache_rows: torch.Tensor, measurement: Cloud,
                          old_sensor_in_new: torch.Tensor,
                          measurement_in_scene: torch.Tensor, merge_threshold: float = 0.2):
    """Beam-window merge: the scene side is the previous frame's post-merge
    canvas (``cache_cells`` in the OLD sensor frame, their scene rows in
    ``cache_rows``) moved through the measured sensor motion; no full-scene
    projection. Scene points that became visible only from the new pose are
    not on the cached canvas, so the measurement appends there instead of
    merging. Returns (new scene, new cache cells in the NEW sensor frame,
    their scene rows)."""
    cap = scene.capacity
    moved = Cloud(geometry.transform_points(old_sensor_in_new, cache_cells.xy),
                  geometry.rotate_vectors(old_sensor_in_new, cache_cells.normal),
                  cache_cells.valid)
    scene_canvas = projector_op.project_local(proj, moved)
    meas_canvas = projector_op.project_local(proj, measurement)
    m_ok = meas_canvas.valid & (meas_canvas.depth <= 0.9 * proj.range_max)
    s_ok = scene_canvas.valid
    m_idx = torch.clamp(meas_canvas.idx, min=0)
    w_idx = torch.clamp(scene_canvas.idx, min=0)
    s_row = cache_rows[w_idx]
    do_merge, do_replace, do_append = _beam_decisions(
        meas_canvas.depth, m_ok, scene_canvas.depth, s_ok, merge_threshold)
    modify = do_merge | do_replace

    mp_s, mn_s = measurement.xy[m_idx], measurement.normal[m_idx]
    sp_s, sn_s = moved.xy[w_idx], moved.normal[w_idx]
    upd_p_s = torch.where(do_merge[:, None], 0.5 * (sp_s + mp_s), mp_s)
    upd_n_s = torch.where(do_merge[:, None], _unit_mean(sn_s, mn_s), mn_s)

    upd_p = geometry.transform_points(measurement_in_scene, upd_p_s)
    upd_n = geometry.rotate_vectors(measurement_in_scene, upd_n_s)
    tgt = torch.where(modify & (s_row >= 0), s_row, torch.full_like(s_row, cap))
    xy, nm = _put_rows(scene.xy, tgt, upd_p), _put_rows(scene.normal, tgt, upd_n)
    xy, nm, valid, slot, _ = _append_tail(
        xy, nm, scene.valid, do_append,
        geometry.transform_points(measurement_in_scene, mp_s),
        geometry.rotate_vectors(measurement_in_scene, mn_s))

    neg1 = torch.full_like(slot, -1)
    cell_rows = torch.where(do_append, torch.where(slot < cap, slot, neg1),
                            torch.where(modify | s_ok, s_row, neg1))
    new_cells = Cloud(torch.where(m_ok[:, None], upd_p_s, sp_s),
                      torch.where(m_ok[:, None], upd_n_s, sn_s),
                      (m_ok | s_ok) & (cell_rows >= 0))
    return Cloud(xy, nm, valid), new_cells, cell_rows


def merge_projective(proj: PolarProjection, scene: Cloud, measurement: Cloud,
                     measurement_in_scene: torch.Tensor, merge_threshold: float = 0.2,
                     return_canvas: bool = False, return_dropped: bool = False):
    """Fuse ``measurement`` (its own frame) into ``scene`` given the
    measurement's pose; same capacity out. Per beam of the canvas seen from
    that pose: a measurement cell beyond 0.9 range_max is discarded; an
    empty scene cell appends; depths within ``merge_threshold`` average
    (normal renormalised); a measurement behind the scene point replaces
    it; one in front of it appends. With ``return_canvas`` also the
    post-merge visible cell per beam in the camera frame and the scene row
    behind it; with ``return_dropped`` the number of appends that did not
    fit."""
    cam = measurement_in_scene
    scene_canvas, scene_local = projector_op.project(proj, cam, scene)
    meas_in_scene = Cloud(geometry.transform_points(cam, measurement.xy),
                          geometry.rotate_vectors(cam, measurement.normal),
                          measurement.valid)
    meas_canvas, meas_local = projector_op.project(proj, cam, meas_in_scene)

    m_ok = meas_canvas.valid & (meas_canvas.depth <= 0.9 * proj.range_max)
    s_ok = scene_canvas.valid
    m_idx = torch.clamp(meas_canvas.idx, min=0)
    s_idx = torch.clamp(scene_canvas.idx, min=0)
    do_merge, do_replace, do_append = _beam_decisions(
        meas_canvas.depth, m_ok, scene_canvas.depth, s_ok, merge_threshold)

    mp, mn = meas_in_scene.xy[m_idx], meas_in_scene.normal[m_idx]
    cap = scene.capacity
    full = torch.full_like(s_idx, cap)
    xy = _put_rows(scene.xy, torch.where(do_merge, s_idx, full),
                   0.5 * (scene.xy[s_idx] + mp))
    nm = _put_rows(scene.normal, torch.where(do_merge, s_idx, full),
                   _unit_mean(scene.normal[s_idx], mn))
    xy = _put_rows(xy, torch.where(do_replace, s_idx, full), mp)
    nm = _put_rows(nm, torch.where(do_replace, s_idx, full), mn)
    xy, nm, valid, slot, dropped = _append_tail(xy, nm, scene.valid, do_append, mp, mn)
    new_scene = Cloud(xy, nm, valid)
    if not return_canvas:
        return (new_scene, dropped) if return_dropped else new_scene

    s_loc_p, s_loc_n = scene_local.xy[s_idx], scene_local.normal[s_idx]
    m_loc_p, m_loc_n = meas_local.xy[m_idx], meas_local.normal[m_idx]
    cell_p = torch.where(do_merge[:, None], 0.5 * (s_loc_p + m_loc_p),
                         torch.where(m_ok[:, None], m_loc_p, s_loc_p))
    cell_n = torch.where(do_merge[:, None], _unit_mean(s_loc_n, m_loc_n),
                         torch.where(m_ok[:, None], m_loc_n, s_loc_n))
    cell_valid = m_ok | s_ok
    neg1 = torch.full_like(slot, -1)
    cell_rows = torch.where(do_append, torch.where(slot < cap, slot, neg1),
                            torch.where(cell_valid, s_idx, neg1))
    cell_rows = torch.where(cell_valid, cell_rows, neg1)
    out = (new_scene, Cloud(cell_p, cell_n, cell_valid), cell_rows)
    return out + (dropped,) if return_dropped else out
