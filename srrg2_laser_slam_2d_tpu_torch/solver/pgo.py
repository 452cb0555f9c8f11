"""SE(2) pose-graph optimization: dense Gauss-Newton over geodesic
pose-pose edges. Counterpart of ``srrg2_laser_slam_2d_tpu/solver/pgo.py``
(``PGOConfig``, ``PoseGraph``, ``linearize``, ``solve_spd_scaled`` and its
batched form, ``optimize`` with ``algorithm="gn"`` or ``"lm"``, ``trim`` /
``untrim_poses``). The loops' exit tests read chi on the host once per
iteration.

Everything stays float32, as in the reference. The per-edge Jacobians are
written out: for the pre-multiplied increments, with A = R(theta_i +
theta_z)^T and S t = (-t_y, t_x),
    J_j = [[A, A S t_j], [0, 1]],   J_i = -J_j.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..utils import geometry


@dataclass(frozen=True)
class PGOConfig:
    max_iterations: int = 20
    epsilon: float = 1e-5
    chi_threshold: float = 0.0      # Cauchy on edges; <= 0 disables
    damping: float = 1e-6
    anchor_weight: float = 1e6      # gauge prior on fixed / unused variables
    algorithm: str = "gn"
    lm_lambda_init: float = 1e-4
    lm_lambda_factor: float = 4.0


class PoseGraph(NamedTuple):
    """Static-capacity pose graph: poses [V, 3], var_valid / var_fixed [V]
    bool, edge_i / edge_j [E] int64, edge_meas [E, 3] (j in i's frame),
    edge_info [E, 3] diagonal information, edge_valid [E] bool."""

    poses: torch.Tensor
    var_valid: torch.Tensor
    var_fixed: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    edge_meas: torch.Tensor
    edge_info: torch.Tensor
    edge_valid: torch.Tensor

    @property
    def var_capacity(self) -> int:
        return self.poses.shape[0]

    @property
    def edge_capacity(self) -> int:
        return self.edge_i.shape[0]


def empty_graph(var_capacity: int, edge_capacity: int, device=None) -> PoseGraph:
    f32 = dict(dtype=torch.float32, device=device)
    return PoseGraph(
        poses=torch.zeros(var_capacity, 3, **f32),
        var_valid=torch.zeros(var_capacity, dtype=torch.bool, device=device),
        var_fixed=torch.zeros(var_capacity, dtype=torch.bool, device=device),
        edge_i=torch.zeros(edge_capacity, dtype=torch.int64, device=device),
        edge_j=torch.zeros(edge_capacity, dtype=torch.int64, device=device),
        edge_meas=torch.zeros(edge_capacity, 3, **f32),
        edge_info=torch.ones(edge_capacity, 3, **f32),
        edge_valid=torch.zeros(edge_capacity, dtype=torch.bool, device=device),
    )


def graph_from_numpy(poses, var_valid, var_fixed, edge_i, edge_j, edge_meas,
                     edge_info, edge_valid, device=None) -> PoseGraph:
    """A PoseGraph on ``device`` from host arrays."""
    def f(x, dtype):
        return torch.as_tensor(x, dtype=dtype).to(device)
    return PoseGraph(
        poses=f(poses, torch.float32), var_valid=f(var_valid, torch.bool),
        var_fixed=f(var_fixed, torch.bool), edge_i=f(edge_i, torch.int64),
        edge_j=f(edge_j, torch.int64), edge_meas=f(edge_meas, torch.float32),
        edge_info=f(edge_info, torch.float32), edge_valid=f(edge_valid, torch.bool),
    )


def edge_residual(xi, xj, meas):
    """Geodesic edge error e = t2v(Z^-1 (Xi^-1 Xj))."""
    return geometry.compose(geometry.inverse(meas), geometry.relative(xi, xj))


def edge_jacobians(xi, xj, meas):
    """d e / d (dx_i, dx_j) for pre-multiplied increments: [E, 3, 3] each."""
    a = xi[:, 2] + meas[:, 2]
    c, s = torch.cos(a), torch.sin(a)
    # A = R(a)^T, A (S t_j) with S t_j = (-y_j, x_j)
    stx, sty = -xj[:, 1], xj[:, 0]
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    Jj = torch.stack([
        torch.stack([c, s, c * stx + s * sty], dim=-1),
        torch.stack([-s, c, -s * stx + c * sty], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return -Jj, Jj


def _edge_chi(graph: PoseGraph, poses: torch.Tensor):
    e = edge_residual(poses[graph.edge_i], poses[graph.edge_j], graph.edge_meas)
    return e, (e * e * graph.edge_info).sum(-1)


def linearize(graph: PoseGraph, chi_threshold: float):
    """Dense normal system: (H [3V, 3V], b [3V], chi, per-edge chi)."""
    v = graph.var_capacity
    dev = graph.poses.device
    xi, xj = graph.poses[graph.edge_i], graph.poses[graph.edge_j]
    e, chi_e = _edge_chi(graph, graph.poses)
    Ji, Jj = edge_jacobians(xi, xj, graph.edge_meas)
    if chi_threshold > 0:
        w = torch.where(chi_e < chi_threshold, torch.ones_like(chi_e),
                        chi_threshold / torch.clamp(chi_e, min=1e-20))
    else:
        w = torch.ones_like(chi_e)
    w = torch.where(graph.edge_valid, w, torch.zeros_like(w))
    wo = w[:, None] * graph.edge_info

    def block(Ja, Jb):
        return torch.einsum("eki,ek,ekj->eij", Ja, wo, Jb)

    ar = torch.arange(3, device=dev)

    def flat(ra, cb):   # [E] block rows / cols -> [E, 3, 3] flat indices
        rows = 3 * ra[:, None, None] + ar[None, :, None]
        cols = 3 * cb[:, None, None] + ar[None, None, :]
        return (rows * (3 * v) + cols).reshape(-1)

    ei, ej = graph.edge_i, graph.edge_j
    Hij = block(Ji, Jj)
    H = torch.zeros(9 * v * v, dtype=torch.float32, device=dev)
    H.index_add_(0, flat(ei, ei), block(Ji, Ji).reshape(-1))
    H.index_add_(0, flat(ej, ej), block(Jj, Jj).reshape(-1))
    H.index_add_(0, flat(ei, ej), Hij.reshape(-1))
    H.index_add_(0, flat(ej, ei), Hij.transpose(-1, -2).reshape(-1))
    bi = torch.einsum("eki,ek,ek->ei", Ji, wo, e)
    bj = torch.einsum("eki,ek,ek->ei", Jj, wo, e)
    b = torch.zeros(v, 3, dtype=torch.float32, device=dev)
    b.index_add_(0, ei, bi)
    b.index_add_(0, ej, bj)
    chi = torch.where(graph.edge_valid, chi_e, torch.zeros_like(chi_e)).sum()
    return H.reshape(3 * v, 3 * v), b.reshape(3 * v), chi, chi_e


def graph_chi(graph: PoseGraph, poses: torch.Tensor | None = None) -> torch.Tensor:
    """Total unrobustified chi over live edges."""
    _, chi_e = _edge_chi(graph, graph.poses if poses is None else poses)
    return torch.where(graph.edge_valid, chi_e, torch.zeros_like(chi_e)).sum()


def solve_spd_scaled(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Jacobi-scaled dense solve with a finite guard (the float32-safe
    normal-equation solve of the reference): a step that is not finite is
    zeroed instead of raised."""
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    Hs = H / d[:, None] / d[None, :]
    x, _ = torch.linalg.solve_ex(Hs, b / d)
    dx = x / d
    return torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))


def solve_spd_scaled_batched(H: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched form of ``solve_spd_scaled``: H [P, n, n], B [P, n, k] ->
    [P, n, k] (the Schur interior eliminations, one solve per partition)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12))
    Hs = H / d[..., :, None] / d[..., None, :]
    X, _ = torch.linalg.solve_ex(Hs, B / d[..., :, None])
    X = X / d[..., :, None]
    return torch.where(torch.isfinite(X), X, torch.zeros_like(X))


def decayed(chi: float, chi_prev: float, epsilon: float) -> bool:
    """The chi-decay exit test of every GN / LM loop."""
    return abs(chi_prev - chi) < epsilon * max(chi_prev, 1e-20)


def _optimize_lm(cfg: PGOConfig, graph: PoseGraph, diag_extra, movable):
    """Levenberg-Marquardt: lambda * diag(H) on the diagonal, a step kept
    only where chi falls, lambda divided / multiplied by
    ``lm_lambda_factor`` on accept / reject and clipped to [1e-9, 1e8]."""
    v = graph.var_capacity
    poses = graph.poses
    lam = torch.tensor(cfg.lm_lambda_init, dtype=torch.float32, device=poses.device)
    it, chi, chi_prev = 0, float("inf"), float("inf")
    chi_t = torch.tensor(chi)
    while it < cfg.max_iterations and not (it > 1 and decayed(chi, chi_prev, cfg.epsilon)):
        H, b, chi_lin, _ = linearize(graph._replace(poses=poses), cfg.chi_threshold)
        H = H + torch.diag(diag_extra)
        dx = solve_spd_scaled(H + lam * torch.diag(torch.diagonal(H)), -b).reshape(v, 3)
        dx = torch.where(movable, dx, torch.zeros_like(dx))
        cand = geometry.compose(dx, poses)
        chi_new = graph_chi(graph, cand)
        accept = chi_new < chi_lin
        poses = torch.where(accept, cand, poses)
        lam = torch.clamp(torch.where(accept, lam / cfg.lm_lambda_factor,
                                      lam * cfg.lm_lambda_factor), 1e-9, 1e8)
        chi_t = torch.where(accept, chi_new, chi_lin)
        chi_prev, chi = float(chi_lin), float(chi_t)
        it += 1
    return graph._replace(poses=poses), chi_t, it


def optimize(cfg: PGOConfig, graph: PoseGraph):
    """Gauss-Newton with chi-decay termination and the divergence guard, or
    Levenberg-Marquardt (``cfg.algorithm == "lm"``). Returns (graph with
    solved poses, final chi, iterations run)."""
    v = graph.var_capacity
    diag_extra = torch.where(
        graph.var_fixed | ~graph.var_valid,
        torch.full((v,), cfg.anchor_weight, device=graph.poses.device),
        torch.full((v,), cfg.damping, device=graph.poses.device),
    ).repeat_interleave(3)
    movable = (graph.var_valid & ~graph.var_fixed)[:, None]
    if cfg.algorithm == "lm":
        return _optimize_lm(cfg, graph, diag_extra, movable)
    poses = graph.poses
    it, chi, chi_prev = 0, float("inf"), float("inf")
    chi_t = torch.tensor(chi)
    while it < cfg.max_iterations and not (it > 1 and decayed(chi, chi_prev, cfg.epsilon)):
        H, b, chi_t, _ = linearize(graph._replace(poses=poses), cfg.chi_threshold)
        H = H + torch.diag(diag_extra)
        dx = solve_spd_scaled(H, -b).reshape(v, 3)
        dx = torch.where(movable, dx, torch.zeros_like(dx))
        cand = geometry.compose(dx, poses)
        chi_cand = graph_chi(graph, cand)
        ok = torch.isfinite(chi_cand) & (chi_cand <= 1e3 * chi_t + 1e3)
        poses = torch.where(ok, cand, poses)
        chi_prev, chi = chi, float(chi_t)
        it += 1
    return graph._replace(poses=poses), chi_t, it


def round_capacity(n: int, minimum: int = 16) -> int:
    c = minimum
    while c < n:
        c *= 2
    return c


def trim(graph: PoseGraph, n_vars: int, n_edges: int) -> tuple[PoseGraph, int, int]:
    """Slice a static-capacity graph down to power-of-two capacities that
    cover the live variables and edges, so the dense solve is sized to the
    problem. Returns (trimmed graph, variable capacity, edge capacity)."""
    vc = min(round_capacity(n_vars), graph.var_capacity)
    ec = min(round_capacity(n_edges), graph.edge_capacity)
    trimmed = PoseGraph(
        poses=graph.poses[:vc], var_valid=graph.var_valid[:vc],
        var_fixed=graph.var_fixed[:vc], edge_i=graph.edge_i[:ec], edge_j=graph.edge_j[:ec],
        edge_meas=graph.edge_meas[:ec], edge_info=graph.edge_info[:ec],
        edge_valid=graph.edge_valid[:ec])
    return trimmed, vc, ec


def untrim_poses(full: PoseGraph, solved: PoseGraph) -> PoseGraph:
    """The full-capacity graph with the solved pose block written back."""
    poses = full.poses.clone()
    poses[: solved.var_capacity] = solved.poses
    return full._replace(poses=poses)
