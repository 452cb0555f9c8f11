"""A frozen copy of the port's dense Gauss-Newton pose-graph solve
(``linearize``, ``solve_spd_scaled`` and ``optimize`` with ``algorithm ==
"gn"`` of ``solver/pgo.py``), as the benchmark was written. The corridor
cell's reference for the solve: it runs in float64 on the graph the
program built.

Floating tensors take the default dtype (``_f()``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import prep


def _f() -> torch.dtype:
    return torch.get_default_dtype()


class _Graph(NamedTuple):
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


def edge_residual(xi, xj, meas):
    """Geodesic edge error e = t2v(Z^-1 (Xi^-1 Xj))."""
    return prep.compose(prep.inverse(meas), prep.compose(prep.inverse(xi), xj))


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


def _edge_chi(graph, poses: torch.Tensor):
    e = edge_residual(poses[graph.edge_i], poses[graph.edge_j], graph.edge_meas)
    return e, (e * e * graph.edge_info).sum(-1)


def linearize(graph, chi_threshold: float):
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
    H = torch.zeros(9 * v * v, dtype=_f(), device=dev)
    H.index_add_(0, flat(ei, ei), block(Ji, Ji).reshape(-1))
    H.index_add_(0, flat(ej, ej), block(Jj, Jj).reshape(-1))
    H.index_add_(0, flat(ei, ej), Hij.reshape(-1))
    H.index_add_(0, flat(ej, ei), Hij.transpose(-1, -2).reshape(-1))
    bi = torch.einsum("eki,ek,ek->ei", Ji, wo, e)
    bj = torch.einsum("eki,ek,ek->ei", Jj, wo, e)
    b = torch.zeros(v, 3, dtype=_f(), device=dev)
    b.index_add_(0, ei, bi)
    b.index_add_(0, ej, bj)
    chi = torch.where(graph.edge_valid, chi_e, torch.zeros_like(chi_e)).sum()
    return H.reshape(3 * v, 3 * v), b.reshape(3 * v), chi, chi_e


def solve_spd_scaled(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Jacobi-scaled dense solve with a finite guard (the float32-safe
    normal-equation solve of the reference): a step that is not finite is
    zeroed instead of raised."""
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    Hs = H / d[:, None] / d[None, :]
    # no linear solver takes bfloat16: the control solves its bfloat16
    # system in float32, the nearest precision that has one
    solve_dt = torch.float32 if Hs.dtype in (torch.bfloat16, torch.float16) else Hs.dtype
    x, _ = torch.linalg.solve_ex(Hs.to(solve_dt), (b / d).to(solve_dt))
    dx = x.to(Hs.dtype) / d
    return torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))


def decayed(chi: float, chi_prev: float, epsilon: float) -> bool:
    """The chi-decay exit test of every GN / LM loop."""
    return abs(chi_prev - chi) < epsilon * max(chi_prev, 1e-20)


def graph_chi(graph, poses: torch.Tensor) -> torch.Tensor:
    """Total unrobustified chi over the live edges at ``poses``."""
    _, chi_e = _edge_chi(graph, poses)
    return torch.where(graph.edge_valid, chi_e, torch.zeros_like(chi_e)).sum()


def optimize(cfg: dict, poses, var_valid, var_fixed, edge_i, edge_j, edge_meas, edge_info,
             edge_valid):
    """Gauss-Newton with chi-decay termination and the divergence guard on
    a graph given as tensors -> solved poses [V, 3]. ``cfg``: the port's
    ``PGOConfig`` fields (``max_iterations``, ``epsilon``, ``chi_threshold``,
    ``damping``, ``anchor_weight``)."""
    graph = _Graph(poses.to(_f()), var_valid, var_fixed, edge_i, edge_j, edge_meas.to(_f()),
                   edge_info.to(_f()), edge_valid)
    v = poses.shape[0]
    dev = poses.device
    diag_extra = torch.where(var_fixed | ~var_valid,
                             torch.full((v,), cfg["anchor_weight"], device=dev),
                             torch.full((v,), cfg["damping"], device=dev)).repeat_interleave(3)
    movable = (var_valid & ~var_fixed)[:, None]
    P = graph.poses
    it, chi, chi_prev = 0, float("inf"), float("inf")
    while it < cfg["max_iterations"] and not (it > 1 and decayed(chi, chi_prev, cfg["epsilon"])):
        H, b, chi_t, _ = linearize(graph._replace(poses=P), cfg["chi_threshold"])
        H = H + torch.diag(diag_extra)
        dx = solve_spd_scaled(H, -b).reshape(v, 3)
        dx = torch.where(movable, dx, torch.zeros_like(dx))
        cand = prep.compose(dx, P)
        _, chi_e = _edge_chi(graph, cand)
        chi_cand = torch.where(graph.edge_valid, chi_e, torch.zeros_like(chi_e)).sum()
        ok = torch.isfinite(chi_cand) & (chi_cand <= 1e3 * chi_t + 1e3)
        P = torch.where(ok, cand, P)
        chi_prev, chi = chi, float(chi_t)
        it += 1
    return P
