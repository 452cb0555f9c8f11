"""SE(2) projective ICP in plain PyTorch: the aligner of the per-message
tracker's reference route and of the loop detector. Counterpart of
``srrg2_laser_slam_2d_tpu/ops/icp.py``: ``AlignerConfig``, the beam-space
projective correspondence finder, the robustified plane-to-plane
linearization, the odometry prior and the outer loop ``align``.

Every function takes leading batch dimensions, so one call aligns a query
scene against K candidate scenes (the JAX package maps ``align`` over them)
and ``align_multi`` matches all cues of a multi-rangefinder robot in one
batched call. ``AlignerConfig.finder`` picks the correspondence finder:
``projective`` (beam space), ``nn_grid`` (a jump-flooded nearest field,
built once per ``align`` call) or ``bruteforce`` (exact bounded nearest
neighbour), the last two in ``ops/correspond.py``.

On the card ``align`` replays a captured CUDA graph of its whole iteration
chain where the chain has no host read (``graph_route``) and its shapes
have been seen before: one launch in place of some 7,600 small PyTorch
kernels at the loop detector's 30 iterations. The graph runs the very
kernels the eager body (``_align_eager``) runs, in the same order, so both
routes give the same bits on one card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..utils import cloud as cloud_lib
from ..utils import geometry
from ..utils.cloud import Cloud
from . import _cuda
from . import projector as projector_op
from .projector import Canvas, PolarProjection


@dataclass(frozen=True)
class AlignerConfig:
    """Parameter surface of MultiAligner2D and its laser / odometry slices
    (same fields and defaults as the JAX package, so both read one file)."""

    max_iterations: int = 10
    min_num_inliers: int = 10
    enable_inlier_only_runs: bool = False
    keep_only_inlier_correspondences: bool = False
    epsilon: float | None = None
    damping: float = 0.0
    point_distance: float = 0.5
    normal_cos: float = 0.8
    chi_threshold: float = 0.05
    min_num_correspondences: int = 0
    odom_weight: float = 1.0
    finder: str = "projective"
    finder_max_distance: float = 1.0
    finder_resolution: float = 0.05
    finder_grid_size: int = 256


def solve3(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 solve (Cramer, determinant guard 1e-20): H [..., 3, 3],
    b [..., 3] -> [..., 3]."""
    a00, a01, a02 = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    a10, a11, a12 = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    a20, a21, a22 = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    det = (a00 * (a11 * a22 - a12 * a21) - a01 * (a10 * a22 - a12 * a20)
           + a02 * (a10 * a21 - a11 * a20))
    inv_det = torch.where(torch.abs(det) > 1e-20, 1.0 / det, torch.zeros_like(det))
    x0 = ((a11 * a22 - a12 * a21) * b0 + (a02 * a21 - a01 * a22) * b1
          + (a01 * a12 - a02 * a11) * b2) * inv_det
    x1 = ((a12 * a20 - a10 * a22) * b0 + (a00 * a22 - a02 * a20) * b1
          + (a02 * a10 - a00 * a12) * b2) * inv_det
    x2 = ((a10 * a21 - a11 * a20) * b0 + (a01 * a20 - a00 * a21) * b1
          + (a00 * a11 - a01 * a10) * b2) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


class AlignResult(NamedTuple):
    estimate: torch.Tensor              # [..., 3] moving-in-fixed
    chi: torch.Tensor                   # [...] total robust chi of the last iteration
    num_correspondences: torch.Tensor   # [...] int64
    num_inliers: torch.Tensor           # [...] int64
    chi_inliers: torch.Tensor           # [...] mean chi over the inliers
    iterations: torch.Tensor            # [...] int64 iterations run
    stats: torch.Tensor                 # [..., max_iterations, 4]: chi, n_corr, n_inl, chi_inl_mean


class Correspondences(NamedTuple):
    """Beam-indexed correspondences ([..., cols] each)."""

    fixed_idx: torch.Tensor
    moving_idx: torch.Tensor
    valid: torch.Tensor


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., N, 2] rows at idx [..., K] -> [..., K, 2]."""
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + (2,)))


def find_projective(proj: PolarProjection, fixed_canvas: Canvas, fixed: Cloud,
                    moving: Cloud, estimate: torch.Tensor,
                    point_distance: float, normal_cos: float) -> Correspondences:
    """Match the fixed canvas against the moving cloud seen through
    ``estimate`` (moving-in-fixed), beam by beam: both beams hit, depths
    within ``point_distance``, normals within ``normal_cos``."""
    moved = Cloud(
        xy=geometry.transform_points(estimate, moving.xy),
        normal=geometry.rotate_vectors(estimate, moving.normal),
        valid=moving.valid,
    )
    mov_canvas = projector_op.project_local(proj, moved)
    both = fixed_canvas.valid & mov_canvas.valid
    close = torch.abs(fixed_canvas.depth - mov_canvas.depth) <= point_distance
    f_idx = torch.clamp(fixed_canvas.idx, min=0)
    m_idx = torch.clamp(mov_canvas.idx, min=0)
    ndot = (_take(moved.normal, m_idx) * _take(fixed.normal, f_idx)).sum(-1)
    ok = both & close & (ndot >= normal_cos)
    return Correspondences(fixed_idx=f_idx, moving_idx=m_idx, valid=ok)


def p2p_linearize(estimate: torch.Tensor, fixed: Cloud, moving: Cloud,
                  corr: Correspondences, chi_threshold: float, inlier_only: bool = False):
    """Robustified plane-to-plane linearization over a correspondence set:
    (H [..., 3, 3], b [..., 3], chi_total, num_inliers, chi_inlier_sum).
    Error e1 = n_f . (R p_m + t - p_f), e23 = R n_m - n_f; Jacobian for the
    pre-multiplied increment."""
    p_m, n_m = _take(moving.xy, corr.moving_idx), _take(moving.normal, corr.moving_idx)
    p_f, n_f = _take(fixed.xy, corr.fixed_idx), _take(fixed.normal, corr.fixed_idx)
    m = corr.valid
    p_pred = geometry.transform_points(estimate, p_m)
    n_pred = geometry.rotate_vectors(estimate, n_m)

    e1 = (n_f * (p_pred - p_f)).sum(-1)
    e23 = n_pred - n_f
    chi = e1 * e1 + (e23 * e23).sum(-1)
    sp = torch.stack([-p_pred[..., 1], p_pred[..., 0]], dim=-1)
    sn = torch.stack([-n_pred[..., 1], n_pred[..., 0]], dim=-1)
    j1 = torch.cat([n_f, (n_f * sp).sum(-1, keepdim=True)], dim=-1)

    one = torch.ones_like(chi)
    if inlier_only and chi_threshold > 0:
        w = (chi < chi_threshold).to(chi.dtype)
    elif chi_threshold > 0:
        w = torch.where(chi < chi_threshold, one, chi_threshold / torch.clamp(chi, min=1e-20))
    else:
        w = one
    w = torch.where(m, w, torch.zeros_like(w))

    H = torch.einsum("...c,...ci,...cj->...ij", w, j1, j1)
    b = torch.einsum("...c,...ci,...c->...i", w, j1, e1)
    extra = torch.zeros_like(H)
    extra[..., 2, 2] = (w * (sn * sn).sum(-1)).sum(-1)
    H = H + extra
    b = torch.cat([b[..., :2], (b[..., 2] + (w * (sn * e23).sum(-1)).sum(-1))[..., None]], dim=-1)

    chi_total = (m.to(chi.dtype) * chi).sum(-1)
    inl = m & (chi < chi_threshold) if chi_threshold > 0 else m
    return H, b, chi_total, inl.sum(-1), torch.where(inl, chi, torch.zeros_like(chi)).sum(-1)


def odom_prior_linearize(estimate: torch.Tensor, prior: torch.Tensor, weight: float):
    """Geodesic prior e = t2v(prior^-1 estimate) tying the estimate to the
    odometry prediction: (H, b, chi) for the pre-multiplied increment."""
    A = geometry.inverse(prior)
    e = geometry.compose(A, estimate)
    ca, sa = torch.cos(A[..., 2]), torch.sin(A[..., 2])
    tx, ty = estimate[..., 0], estimate[..., 1]
    zero, one = torch.zeros_like(ca), torch.ones_like(ca)
    J = torch.stack([
        torch.stack([ca, -sa, ca * -ty - sa * tx], dim=-1),
        torch.stack([sa, ca, sa * -ty + ca * tx], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    Jt = J.transpose(-1, -2)
    H = weight * (Jt @ J)
    b = weight * (Jt @ e[..., None])[..., 0]
    return H, b, weight * (e * e).sum(-1)


def _iterate(cfg: AlignerConfig, iteration, initial: torch.Tensor) -> AlignResult:
    """The outer loop: at most ``max_iterations`` updates; with ``epsilon``
    a batch element stops once its chi decays by less than that ratio."""
    max_it = cfg.max_iterations
    estimate = initial.to(torch.float32)
    batch = estimate.shape[:-1]
    dev = estimate.device
    stats = torch.zeros(batch + (max_it, 4), dtype=torch.float32, device=dev)
    chi = torch.full(batch, float("inf"), device=dev)
    its = torch.zeros(batch, dtype=torch.int64, device=dev)
    active = torch.ones(batch, dtype=torch.bool, device=dev)
    for it in range(max_it):
        new_estimate, (c, n_corr, n_inl, chi_inl) = iteration(estimate)
        row = torch.stack([c, n_corr.to(torch.float32), n_inl.to(torch.float32), chi_inl], dim=-1)
        stats[..., it, :] = torch.where(active[..., None], row, stats[..., it, :])
        estimate = torch.where(active[..., None], new_estimate, estimate)
        chi_prev, chi = chi, torch.where(active, c, chi)
        its = its + active.to(torch.int64)
        if cfg.epsilon is not None:
            # the update of the iteration that decayed is kept, then the element stops
            decayed = torch.abs(chi_prev - c) < cfg.epsilon * torch.clamp(chi_prev, min=1e-20)
            active = active & ~(decayed & (it > 0))
            if not bool(active.any()):
                break
    last = torch.clamp(its - 1, min=0)
    final = torch.gather(stats, -2, last[..., None, None].expand(batch + (1, 4)))[..., 0, :]
    return AlignResult(estimate=estimate, chi=chi,
                       num_correspondences=final[..., 1].to(torch.int64),
                       num_inliers=final[..., 2].to(torch.int64),
                       chi_inliers=final[..., 3], iterations=its, stats=stats)


def align_multi(cfg: AlignerConfig, proj: PolarProjection, fixed_cues: Cloud,
                extrinsics: torch.Tensor, moving: Cloud, initial: torch.Tensor,
                odom_prior: torch.Tensor | None = None) -> AlignResult:
    """Multi-cue alignment: MultiAligner2D with one laser slice per
    rangefinder. ``fixed_cues`` [C, N, ...] holds each cue's measurement in
    its own sensor frame, ``extrinsics`` [C, 3] the sensor-in-robot poses,
    ``moving`` the shared clip in the previous robot frame; the estimate
    maps prev-robot -> curr-robot. Cue c matches in its sensor frame (its
    own canvas) at inverse(e_c) * estimate and linearizes in the robot frame
    against its measurement moved by e_c; the normal systems are summed over
    the cue axis, then the odometry prior and the damping enter once."""
    n_cues = extrinsics.shape[0]
    canvases = projector_op.project_local(proj, fixed_cues)
    fixed_rob = cloud_lib.transform(fixed_cues, extrinsics)
    inv_extr = geometry.inverse(extrinsics)
    moving_c = moving.map(lambda x: x.expand((n_cues,) + x.shape))
    eye = torch.eye(3, device=initial.device)

    def iteration(estimate):
        est_c = estimate.expand(n_cues, 3)
        corr = find_projective(proj, canvases, fixed_cues, moving_c,
                               geometry.compose(inv_extr, est_c),
                               cfg.point_distance, cfg.normal_cos)
        H, b, chi, n_inl, chi_inl_sum = p2p_linearize(est_c, fixed_rob, moving_c, corr,
                                                      cfg.chi_threshold)
        H, b, chi = H.sum(0), b.sum(0), chi.sum(0)
        n_corr, n_inl, chi_inl_sum = corr.valid.sum(), n_inl.sum(), chi_inl_sum.sum()
        if odom_prior is not None and cfg.odom_weight > 0:
            Ho, bo, chio = odom_prior_linearize(estimate, odom_prior, cfg.odom_weight)
            H, b, chi = H + Ho, b + bo, chi + chio
        H = H + cfg.damping * eye
        ok = (n_corr >= max(cfg.min_num_correspondences, 1)) & (n_inl >= cfg.min_num_inliers)
        dx = solve3(H + (1.0 - ok.to(torch.float32)) * eye * 1e6, -b)
        dx = torch.where(ok, dx, torch.zeros_like(dx))
        chi_inl_mean = chi_inl_sum / torch.clamp(n_inl.to(torch.float32), min=1.0)
        return geometry.compose(dx, estimate), (chi, n_corr, n_inl, chi_inl_mean)

    return _iterate(cfg, iteration, initial)


# ``align``'s card calls, module globals, always on: graphs captured (a
# key's second call), calls served by replaying a captured graph, and calls
# run eagerly (those the route rule sends to eager mode and a key's first)
graph_captures = 0
graph_replays = 0
eager_card_calls = 0


def graph_route(cfg: AlignerConfig, device: torch.device) -> bool:
    """Whether ``align`` may replay a captured graph: on a CUDA device, with
    the projective finder (the grid finder builds its field per call) and
    without ``epsilon`` (whose stop test reads the device every
    iteration). Every other call runs eagerly."""
    return device.type == "cuda" and cfg.finder == "projective" and cfg.epsilon is None


def align(cfg: AlignerConfig, proj: PolarProjection, fixed: Cloud, moving: Cloud,
          initial: torch.Tensor, odom_prior: torch.Tensor | None = None) -> AlignResult:
    """Full multi-iteration alignment; ``initial`` and the estimate are
    moving-in-fixed poses [..., 3]. ``fixed`` carries the batch dimensions
    of ``initial``; ``moving`` may have none and is then shared."""
    global eager_card_calls
    if graph_route(cfg, initial.device):
        return _align_graphed(cfg, proj, fixed, moving, initial, odom_prior)
    if initial.device.type == "cuda":
        eager_card_calls += 1
    return _align_eager(cfg, proj, fixed, moving, initial, odom_prior)


class _Captured(NamedTuple):
    """One captured ``_align_eager`` call: the graph, its static inputs
    (fixed xy, normal, valid; moving xy, normal, valid; initial; the prior
    where given) and result, and what the capture moved of the kernel
    wrappers' counters (``_cuda.counter_moves``)."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    result: AlignResult
    counted: dict


# by key: a key's captured call, or None once its first call has run
# eagerly. Nothing is evicted: each caller repeats a few shapes (every card
# path of ``chip_smoke.py`` in one process makes 24 keys, 15 of them twice
# or more, each graph holding one call's memory)
_GRAPHS: dict = {}


def _capture(cfg: AlignerConfig, proj: PolarProjection, inputs: tuple) -> _Captured:
    """Copy ``inputs`` into static buffers, run ``_align_eager`` on them
    once on a side stream (lazy set-up stays out of the graph), then capture
    it. The graph is not run yet."""
    static = tuple(t.clone(memory_format=torch.contiguous_format) for t in inputs)

    def call() -> AlignResult:
        return _align_eager(cfg, proj, Cloud(*static[:3]), Cloud(*static[3:6]), static[6],
                            static[7] if len(static) > 7 else None)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _cuda.counters()
    with torch.cuda.graph(graph):
        result = call()
    return _Captured(graph, static, result, _cuda.counter_moves(before))


def _align_graphed(cfg: AlignerConfig, proj: PolarProjection, fixed: Cloud, moving: Cloud,
                   initial: torch.Tensor, odom_prior: torch.Tensor | None) -> AlignResult:
    """``_align_eager`` by key: the key's first call runs eagerly, its
    second captures a graph and replays it, and every later call replays
    it. A shape seen once costs no capture. The key: the configuration, the
    projection, the z-buffer backend, the TF32 setting and every input's
    shape, type and device (so the batch, both capacities and the prior's
    presence). A replay copies the inputs into the key's buffers and returns
    a copy of the result (the next replay overwrites the graph's)."""
    global graph_captures, graph_replays, eager_card_calls
    inputs = (*fixed, *moving, initial) + (() if odom_prior is None else (odom_prior,))
    key = (cfg, proj, projector_op.ZBUFFER_BACKEND, torch.backends.cuda.matmul.allow_tf32,
           tuple((t.shape, t.dtype, t.device) for t in inputs))
    if key not in _GRAPHS:
        _GRAPHS[key] = None
        eager_card_calls += 1
        return _align_eager(cfg, proj, fixed, moving, initial, odom_prior)
    with torch.cuda.device(initial.device):
        entry = _GRAPHS[key]
        if entry is None:
            entry = _GRAPHS[key] = _capture(cfg, proj, inputs)
            graph_captures += 1
        else:
            for buf, t in zip(entry.inputs, inputs):
                buf.copy_(t)
            _cuda.count_again(entry.counted)
            graph_replays += 1
        entry.graph.replay()
        return AlignResult(*(t.clone() for t in entry.result))


def _align_eager(cfg: AlignerConfig, proj: PolarProjection, fixed: Cloud, moving: Cloud,
                 initial: torch.Tensor, odom_prior: torch.Tensor | None = None) -> AlignResult:
    """``align``'s body, one PyTorch operation at a time."""
    batch = initial.shape[:-1]
    if moving.xy.dim() == 2 and batch:
        moving = moving.map(lambda x: x.expand(batch + x.shape))
    if cfg.finder == "projective":
        fixed_canvas = projector_op.project_local(proj, fixed)

        def find(estimate):
            return find_projective(proj, fixed_canvas, fixed, moving, estimate,
                                   cfg.point_distance, cfg.normal_cos)
    elif cfg.finder == "nn_grid":
        from . import correspond, distance_map

        field = distance_map.build(fixed, cfg.finder_grid_size, cfg.finder_grid_size,
                                   cfg.finder_resolution)

        def find(estimate):
            return correspond.find_nn_grid(field, fixed, moving, estimate,
                                           cfg.finder_max_distance, cfg.normal_cos)
    elif cfg.finder == "bruteforce":
        from . import correspond

        def find(estimate):
            return correspond.find_bruteforce_nn(fixed, moving, estimate,
                                                 cfg.finder_max_distance, cfg.normal_cos)
    else:
        raise ValueError(f"unknown finder {cfg.finder!r}")
    eye = torch.eye(3, device=initial.device)

    def make_iteration(inlier_only: bool):
        def iteration(estimate):
            corr = find(estimate)
            n_corr = corr.valid.sum(-1)
            H, b, chi, n_inl, chi_inl_sum = p2p_linearize(
                estimate, fixed, moving, corr, cfg.chi_threshold, inlier_only=inlier_only)
            if odom_prior is not None and cfg.odom_weight > 0:
                Ho, bo, chio = odom_prior_linearize(estimate, odom_prior, cfg.odom_weight)
                H, b, chi = H + Ho, b + bo, chi + chio
            H = H + cfg.damping * eye
            # a rank-deficient system keeps the estimate; the solve needs
            # min_num_inliers ACTUAL inliers, not merely correspondences
            ok = (n_corr >= max(cfg.min_num_correspondences, 1)) & (n_inl >= cfg.min_num_inliers)
            okf = ok.to(torch.float32)[..., None, None]
            dx = solve3(H + (1.0 - okf) * eye * 1e6, -b)
            dx = torch.where(ok[..., None], dx, torch.zeros_like(dx))
            new_estimate = geometry.compose(dx, estimate)
            chi_inl_mean = chi_inl_sum / torch.clamp(n_inl.to(torch.float32), min=1.0)
            return new_estimate, (chi, n_corr, n_inl, chi_inl_mean)
        return iteration

    res = _iterate(cfg, make_iteration(False), initial)
    if cfg.enable_inlier_only_runs and cfg.chi_threshold > 0:
        refined = _iterate(cfg, make_iteration(True), res.estimate)
        res = refined._replace(iterations=res.iterations + refined.iterations)
    if cfg.keep_only_inlier_correspondences and cfg.chi_threshold > 0:
        est, (chi, n_corr, n_inl, chi_inl) = make_iteration(True)(res.estimate)
        res = AlignResult(estimate=est, chi=chi, num_correspondences=n_corr,
                          num_inliers=n_inl, chi_inliers=chi_inl,
                          iterations=res.iterations + 1, stats=res.stats)
    return res
