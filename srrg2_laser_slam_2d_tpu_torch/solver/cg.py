"""Matrix-free preconditioned conjugate gradient for large pose graphs.
Counterpart of ``srrg2_laser_slam_2d_tpu/solver/cg.py``.

Gauss-Newton outer iterations whose normal system H dx = -b is solved by
block-Jacobi-preconditioned CG, with H never materialized: x -> Hx is two
gathers, a per-edge 3x3 block product and two scatter-adds, all O(E). This
is the path for the city-scale (1M+ node) graphs; the dense solver
(``solver/pgo.py``) stays the oracle for small ones.

Layout: per-edge quantities are stacks with the edge index LAST ([3, E]
residuals and weights, [3, 3, E] Jacobian blocks, ``JT[k, i, e]`` = d
res_k / d x_i at edge e), per-variable vectors are [3, V], so every
operation is a row operation over [E] or [V], coalesced on the card.

Loops: the Gauss-Newton exit (chi decay) and the PCG exit (``dot(r, r)``
against the tolerance) are read on the host once per iteration, which
gives the JAX loops' values and iteration counts at the cost of one
synchronisation per CG iteration.

Sums: without an ``EdgeOrder`` the scatters are ``index_add_`` (atomics on
the card, so repeated card runs are not bit-identical); with one they are
sorted segment sums without atomics: each row gathers its contributions in
row-sorted order from a [V, L] table (L = the most valid edges a row
has, short rows padded with a zero slot; an invalid edge contributes an
exact zero and is left out) and sums them. ``torch.segment_reduce`` did the
same sums 13x slower: 2.06 s a GN iteration of 100 CG iterations on the
1,048,576-node lattice against this table's 0.157 s (NVIDIA H100 80GB
HBM3 at 700 W, ``PERF.md``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..utils import geometry
from .pgo import PoseGraph, decayed, edge_jacobians, edge_residual


@dataclass(frozen=True)
class CGConfig:
    gn_iterations: int = 10
    cg_iterations: int = 50
    cg_tolerance: float = 1e-6
    epsilon: float = 1e-5          # GN chi-decay termination
    chi_threshold: float = 0.0     # Cauchy on edges
    damping: float = 1e-6
    anchor_weight: float = 1e6
    # linearize the edge Jacobians in chunks of this many edges (bounds the
    # working memory; 0 = one shot); used when it divides the edge capacity
    jac_chunk: int = 0


class EdgeOrder(NamedTuple):
    """Static row-sorted ordering of the 2E per-edge contributions
    (i-endpoint rows, then j-endpoint rows), built once per graph topology
    on the host: the scatters become sorted segment sums."""

    perm: torch.Tensor      # [2E] permutation into row-sorted order
    rows: torch.Tensor      # [2E] sorted destination rows
    slots: torch.Tensor     # [V, L] each row's valid contributions, sorted (pad: 2E)


# the slot table may hold at most this many entries per contribution
SLOT_TABLE_GROWTH = 16


def prepare_edge_order(graph: PoseGraph) -> EdgeOrder:
    """Host-side: sort the stacked (edge_i ++ edge_j) destination rows. The
    slot table is [V, L] for L the most valid edges at one variable, so a
    graph with a hub (a variable on a large share of the edges) is refused:
    solve it without an order."""
    dev = graph.poses.device
    rows = np.concatenate([graph.edge_i.cpu().numpy(), graph.edge_j.cpu().numpy()])
    perm = np.argsort(rows, kind="stable")
    valid = np.tile(graph.edge_valid.cpu().numpy(), 2)[perm]
    vrows, vperm = rows[perm][valid], perm[valid]
    lengths = np.bincount(vrows, minlength=graph.var_capacity)
    width = max(int(lengths.max()) if len(vrows) else 1, 1)
    v = graph.var_capacity
    if v * width > SLOT_TABLE_GROWTH * (len(rows) + v):
        raise ValueError(f"a variable has {width} edges: the sorted-sum table [{v}, {width}] "
                         "is too large for this graph; solve it with order=None")
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    slots = np.full((v, width), len(rows), np.int64)
    slots[vrows, np.arange(len(vrows)) - starts[vrows]] = vperm
    return EdgeOrder(perm=torch.as_tensor(perm, device=dev),
                     rows=torch.as_tensor(rows[perm], device=dev),
                     slots=torch.as_tensor(slots, device=dev))


def _scatter_rows(ci: torch.Tensor, cj: torch.Tensor, v: int, graph: PoseGraph,
                  order: EdgeOrder | None) -> torch.Tensor:
    """[C, E] + [C, E] -> [C, V]: component rows of ci summed into the rows
    of ``edge_i``, of cj into those of ``edge_j``."""
    if order is None:
        out = torch.zeros(ci.shape[0], v, dtype=ci.dtype, device=ci.device)
        out.index_add_(1, graph.edge_i, ci)
        out.index_add_(1, graph.edge_j, cj)
        return out
    data = torch.cat([ci, cj, ci.new_zeros(ci.shape[0], 1)], dim=1)
    return data[:, order.slots].sum(-1)


def _linearize_blocks(graph: PoseGraph, chi_threshold: float, jac_chunk: int = 0):
    """Per-edge Jacobian blocks, robust weights and residuals in component
    layout: JiT / JjT [3, 3, E], woT / eT [3, E], chi (scalar tensor).

    With ``jac_chunk`` > 0 dividing the edge capacity, the endpoint gathers,
    residuals and Jacobians run over edge chunks of that size, so their
    temporaries are bounded by the chunk."""
    ec = graph.edge_capacity
    poses = graph.poses
    if jac_chunk and ec > jac_chunk and ec % jac_chunk == 0:
        dev = poses.device
        eT = torch.empty(3, ec, dtype=torch.float32, device=dev)
        JiT = torch.empty(3, 3, ec, dtype=torch.float32, device=dev)
        JjT = torch.empty(3, 3, ec, dtype=torch.float32, device=dev)
        for c0 in range(0, ec, jac_chunk):
            sl = slice(c0, c0 + jac_chunk)
            xi, xj = poses[graph.edge_i[sl]], poses[graph.edge_j[sl]]
            meas = graph.edge_meas[sl]
            eT[:, sl] = edge_residual(xi, xj, meas).T
            Ji, Jj = edge_jacobians(xi, xj, meas)
            JiT[:, :, sl] = Ji.permute(1, 2, 0)
            JjT[:, :, sl] = Jj.permute(1, 2, 0)
    else:
        xi, xj = poses[graph.edge_i], poses[graph.edge_j]
        eT = edge_residual(xi, xj, graph.edge_meas).T
        Ji, Jj = edge_jacobians(xi, xj, graph.edge_meas)
        JiT, JjT = Ji.permute(1, 2, 0).contiguous(), Jj.permute(1, 2, 0).contiguous()
    omegaT = graph.edge_info.T                                  # [3, E]
    chi_e = (eT * eT * omegaT).sum(0)                           # [E]
    if chi_threshold > 0:
        w = torch.where(chi_e < chi_threshold, torch.ones_like(chi_e),
                        chi_threshold / torch.clamp(chi_e, min=1e-20))
    else:
        w = torch.ones_like(chi_e)
    w = torch.where(graph.edge_valid, w, torch.zeros_like(w))
    woT = w[None, :] * omegaT                                   # [3, E]
    chi = torch.where(graph.edge_valid, chi_e, torch.zeros_like(chi_e)).sum()
    return JiT, JjT, woT, eT, chi


def _jx(JT: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """u_k = sum_i JT[k, i] x_i: [3, 3, E] x [3, E] -> [3, E]."""
    return JT[:, 0] * x[0] + JT[:, 1] * x[1] + JT[:, 2] * x[2]


def _jtu(JT: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y_i = sum_k JT[k, i] u_k: [3, 3, E] x [3, E] -> [3, E]."""
    return JT[0] * u[0] + JT[1] * u[1] + JT[2] * u[2]


def _apply_H(graph: PoseGraph, JiT, JjT, woT, diag_extra, x3, order=None):
    """y = (H + diag_extra) x without materializing H; x3, y: [3, V]."""
    xi, xj = x3[:, graph.edge_i], x3[:, graph.edge_j]
    u = woT * (_jx(JiT, xi) + _jx(JjT, xj))
    return (_scatter_rows(_jtu(JiT, u), _jtu(JjT, u), graph.var_capacity, graph, order)
            + diag_extra * x3)


# the six entries (i <= j) of a symmetric 3x3 block
_UPPER_I = (0, 0, 0, 1, 1, 2)
_UPPER_J = (0, 1, 2, 1, 2, 2)


def _block_jacobi(graph: PoseGraph, JiT, JjT, woT, diag_extra, order=None):
    """Inverse 3x3 diagonal blocks of H (the preconditioner) as [3, 3, V],
    in closed form (adjugate / determinant); a degenerate block (an empty
    variable) becomes the identity, which keeps PCG well-posed."""
    I, J = list(_UPPER_I), list(_UPPER_J)

    def upper(JT):   # [6, E]: sum_k JT[k, i] w_k JT[k, j]
        t = JT[:, I] * woT[:, None] * JT[:, J]
        return t[0] + t[1] + t[2]

    D = _scatter_rows(upper(JiT), upper(JjT), graph.var_capacity, graph, order)
    D[[0, 3, 5]] += diag_extra
    a, b_, c, d, e_, f = D
    A = d * f - e_ * e_
    B = c * e_ - b_ * f
    C = b_ * e_ - c * d
    Dd = a * f - c * c
    E = b_ * c - a * e_
    F = a * d - b_ * b_
    det = a * A + b_ * B + c * C
    safe = torch.abs(det) > 1e-30
    inv_det = 1.0 / torch.where(safe, det, torch.ones_like(det))
    one, zero = torch.ones_like(det), torch.zeros_like(det)
    p00 = torch.where(safe, A * inv_det, one)
    p11 = torch.where(safe, Dd * inv_det, one)
    p22 = torch.where(safe, F * inv_det, one)
    p01 = torch.where(safe, B * inv_det, zero)
    p02 = torch.where(safe, C * inv_det, zero)
    p12 = torch.where(safe, E * inv_det, zero)
    return torch.stack([torch.stack([p00, p01, p02]), torch.stack([p01, p11, p12]),
                        torch.stack([p02, p12, p22])])


def _apply_precond(P: torch.Tensor, r3: torch.Tensor) -> torch.Tensor:
    return P[:, 0] * r3[0] + P[:, 1] * r3[1] + P[:, 2] * r3[2]


def _dot(a3: torch.Tensor, c3: torch.Tensor) -> torch.Tensor:
    s = (a3 * c3).sum(1)
    return s[0] + s[1] + s[2]


def _pcg(apply_h, P, b3: torch.Tensor, iters: int, tol: float):
    """Standard PCG on the [3, V] block vector space. Returns (x, CG
    iterations run); the exit test is read on the host every iteration."""
    x = torch.zeros_like(b3)
    r = b3
    z = _apply_precond(P, r)
    p = z
    rz = _dot(r, z)
    b2 = float(torch.clamp(_dot(b3, b3), min=1e-30))
    rr = float(_dot(r, r))
    k = 0
    while k < iters and rr > tol * tol * b2:
        hp = apply_h(p)
        alpha = rz / torch.clamp(_dot(p, hp), min=1e-30)
        x = x + alpha * p
        r = r - alpha * hp
        z = _apply_precond(P, r)
        rz_new = _dot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
        rr = float(_dot(r, r))
        k += 1
    return x, k


def optimize_cg(cfg: CGConfig, graph: PoseGraph, order: EdgeOrder | None = None,
                stats: list | None = None):
    """GN + matrix-free PCG. Same contract as ``pgo.optimize``: returns
    (graph with solved poses, chi of the last linearization, GN iterations).

    Pass ``order = prepare_edge_order(graph)`` for large graphs (sorted
    segment sums). ``stats``, where given, receives one dict per GN
    iteration: its chi and its CG iterations."""
    diag_extra = torch.where(graph.var_fixed | ~graph.var_valid,
                             torch.full_like(graph.poses[:, 0], cfg.anchor_weight),
                             torch.full_like(graph.poses[:, 0], cfg.damping))
    movable = (graph.var_valid & ~graph.var_fixed)[:, None]
    poses = graph.poses
    it, chi, chi_prev = 0, float("inf"), float("inf")
    chi_t = torch.tensor(chi)
    while it < cfg.gn_iterations and not (it > 1 and decayed(chi, chi_prev, cfg.epsilon)):
        g = graph._replace(poses=poses)
        JiT, JjT, woT, eT, chi_t = _linearize_blocks(g, cfg.chi_threshold, cfg.jac_chunk)
        u = woT * eT                                            # gradient J^T Omega_w e
        b3 = _scatter_rows(_jtu(JiT, u), _jtu(JjT, u), graph.var_capacity, graph, order)
        P = _block_jacobi(g, JiT, JjT, woT, diag_extra, order)
        dx3, cg_its = _pcg(lambda x3: _apply_H(g, JiT, JjT, woT, diag_extra, x3, order),
                           P, -b3, cfg.cg_iterations, cfg.cg_tolerance)
        dx = torch.where(movable, dx3.T, torch.zeros_like(poses))
        poses = geometry.compose(dx, poses)
        chi_prev, chi = chi, float(chi_t)
        if stats is not None:
            stats.append({"chi": chi, "cg_iterations": cg_its})
        it += 1
    return graph._replace(poses=poses), chi_t, it
