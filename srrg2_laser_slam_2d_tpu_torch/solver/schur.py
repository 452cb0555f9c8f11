"""Schur-complement partitioned Gauss-Newton for pose graphs. Counterpart
of ``srrg2_laser_slam_2d_tpu/solver/schur.py`` (``Partitioning``,
``partition_graph``, ``optimize_schur``; the mesh-sharded variant belongs
to the parallel layer and is not ported).

Partition the graph by index range, eliminate each partition's INTERIOR
variables locally (dense per-partition algebra, the partitions a batch
dimension), reduce the SEPARATOR system, solve it, back-substitute:

  host:   partition assignment, interior / separator classification and
          index maps (once per graph topology, O(V + E))
  device: per partition: linearize its own edges -> dense local system over
          [interior ++ local separator] slots;
          S = H_ss - sum_p H_si H_ii^-1 H_is, solve the separator system,
          back-substitute the interiors.

Numerics follow the reference exactly, because they set the numbers:
float32 throughout with Jacobi-scaled solves and finite guards; the
interior solves of P >= 512 partitions run in chunks of 256 partitions
(so P must then be a multiple of 256); the separator system is solved
densely up to 8,192 rows and by 200 Jacobi-PCG iterations beyond.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import geometry
from . import pgo as pgo_mod
from .pgo import PGOConfig, PoseGraph, decayed

ELIMINATION_CHUNK = 256         # partitions per batched interior solve, P >= 512
DENSE_SEPARATOR_ROWS = 8192     # dense separator solve up to this many rows
SEPARATOR_PCG_ITERATIONS = 200


class Partitioning(NamedTuple):
    """Static partition layout (built on the host, used on the device).

    interior_idx:  [P, I] global variable of each interior slot (pad: V)
    separator_idx: [S] global variable of each separator slot (pad: V)
    edge_part:     [E] partition owning each edge
    ei_local / ej_local: [E] local slot of each endpoint in its owner's
        frame: 0..I-1 interior, I..I+L-1 local separator
    edge_perm:     [P, Ep] edges owned by each partition, padded
    edge_mask:     [P, Ep] validity of edge_perm entries
    sep_local_idx: [P, L] global separator slot of each local separator
        slot (pad: S); local systems are [3(I + L)]-sized, not [3(I + S)]
    """

    interior_idx: torch.Tensor
    separator_idx: torch.Tensor
    edge_part: torch.Tensor
    ei_local: torch.Tensor
    ej_local: torch.Tensor
    edge_perm: torch.Tensor
    edge_mask: torch.Tensor
    sep_local_idx: torch.Tensor

    @property
    def n_parts(self) -> int:
        return self.interior_idx.shape[0]

    @property
    def interior_cap(self) -> int:
        return self.interior_idx.shape[1]

    @property
    def separator_cap(self) -> int:
        return self.separator_idx.shape[0]

    @property
    def edges_per_part(self) -> int:
        return self.edge_perm.shape[1]

    @property
    def sep_local_cap(self) -> int:
        return self.sep_local_idx.shape[1]


def _pow2(n: int) -> int:
    return max(8, 1 << int(np.ceil(np.log2(max(n, 1)))))


def partition_graph(graph: PoseGraph, n_parts: int, n_vars: int | None = None,
                    n_edges: int | None = None) -> Partitioning:
    """Index-range partitioning (local maps are created in trajectory order,
    so contiguous ranges are spatially coherent); the separator is every
    variable touched by a cross-partition edge, plus the fixed ones. A
    vectorized host pass, O(V + E) in time and memory. ``n_edges`` is
    accepted for the reference's signature; the valid flags decide."""
    v_cap = graph.var_capacity
    ei = graph.edge_i.cpu().numpy().astype(np.int64)
    ej = graph.edge_j.cpu().numpy().astype(np.int64)
    ev = graph.edge_valid.cpu().numpy()
    vv = graph.var_valid.cpu().numpy()
    nv = int(n_vars if n_vars is not None else vv.sum())

    part_of = np.minimum((np.arange(v_cap) * n_parts) // max(nv, 1), n_parts - 1)
    cross = ev & (part_of[ei] != part_of[ej])
    is_sep = np.zeros(v_cap, bool)
    is_sep[ei[cross]] = True
    is_sep[ej[cross]] = True
    # fixed variables too: their gauge prior must reach the reduced system
    is_sep |= graph.var_fixed.cpu().numpy() & vv

    sep_list = np.where(is_sep & vv)[0]
    s_cap = _pow2(len(sep_list))
    sep_slot = np.full(v_cap, -1, np.int64)
    sep_slot[sep_list] = np.arange(len(sep_list))

    # interior rank within the own partition (interiors are index-sorted)
    int_ids = np.where(vv & ~is_sep)[0]
    int_parts = part_of[int_ids]
    part_counts = np.bincount(int_parts, minlength=n_parts)
    part_starts = np.concatenate([[0], np.cumsum(part_counts)[:-1]])
    int_rank = np.full(v_cap, -1, np.int64)
    int_rank[int_ids] = np.arange(len(int_ids)) - part_starts[int_parts]
    i_cap = _pow2(int(part_counts.max()) if len(int_ids) else 1)

    interior_idx = np.full((n_parts, i_cap), v_cap, np.int64)
    interior_idx[int_parts, int_rank[int_ids]] = int_ids
    separator_idx = np.full(s_cap, v_cap, np.int64)
    separator_idx[: len(sep_list)] = sep_list

    # an edge belongs to the partition of its i endpoint; a cross edge has
    # both endpoints in the separator, so both are addressable there
    edge_part = np.where(ev, part_of[ei], 0).astype(np.int64)

    # local separator sets: (owner, separator slot) of the owned edges'
    # separator endpoints, plus each separator variable's home partition
    s_len = len(sep_list)
    valid_idx = np.where(ev)[0]
    own_e = edge_part[valid_idx]
    pair_keys = []
    for endp in (ei, ej):
        v_ = endp[valid_idx]
        m = is_sep[v_]
        pair_keys.append(own_e[m] * s_len + sep_slot[v_[m]])
    pair_keys.append(part_of[sep_list] * s_len + np.arange(s_len))
    uniq = np.unique(np.concatenate(pair_keys)) if s_len else np.zeros(0, np.int64)
    up_, ul_ = uniq // max(s_len, 1), uniq % max(s_len, 1)
    cnt_l = np.bincount(up_, minlength=n_parts)
    start_l = np.concatenate([[0], np.cumsum(cnt_l)[:-1]])
    l_cap = _pow2(int(cnt_l.max()) if len(uniq) else 1)
    sep_local_idx = np.full((n_parts, l_cap), s_cap, np.int64)
    sep_local_idx[up_, np.arange(len(uniq)) - start_l[up_]] = ul_

    def local_sep_rank(p_arr, slot_arr):
        pos = np.searchsorted(uniq, p_arr * s_len + slot_arr)
        return (pos - start_l[p_arr]).astype(np.int64)

    ei_local = np.where(ev, int_rank[ei], 0)
    ej_local = np.where(ev, int_rank[ej], 0)
    mi = ev & is_sep[ei]
    mj = ev & is_sep[ej]
    if s_len:
        ei_local[mi] = i_cap + local_sep_rank(edge_part[mi], sep_slot[ei[mi]])
        ej_local[mj] = i_cap + local_sep_rank(edge_part[mj], sep_slot[ej[mj]])

    # per-partition contiguous edge slices (stable sort by owner)
    order = valid_idx[np.argsort(edge_part[valid_idx], kind="stable")]
    counts_e = np.bincount(edge_part[valid_idx], minlength=n_parts)
    starts_e = np.concatenate([[0], np.cumsum(counts_e)[:-1]])
    ep_cap = _pow2(int(counts_e.max()) if len(valid_idx) else 1)
    edge_perm = np.zeros((n_parts, ep_cap), np.int64)
    edge_mask = np.zeros((n_parts, ep_cap), bool)
    ranks = np.arange(len(order)) - starts_e[edge_part[order]]
    edge_perm[edge_part[order], ranks] = order
    edge_mask[edge_part[order], ranks] = True

    dev = graph.poses.device
    return Partitioning(*(torch.as_tensor(a, device=dev) for a in (
        interior_idx, separator_idx, edge_part, ei_local, ej_local, edge_perm, edge_mask,
        sep_local_idx)))


def _block(Ja, wo, Jb):
    return torch.einsum("eki,ek,ekj->eij", Ja, wo, Jb)


def _partition_systems(cfg: PGOConfig, graph: PoseGraph, part: Partitioning, poses):
    """Dense local systems of all partitions at once: (H [P, n3, n3],
    b [P, n3], chi [P]) with n3 = 3 (I + L). Each partition linearizes only
    its own edge slice (``edge_perm``), O(E / P) a partition."""
    v_cap = graph.var_capacity
    P, I, L = part.n_parts, part.interior_cap, part.sep_local_cap
    n3 = 3 * (I + L)
    dev = poses.device
    perm = part.edge_perm.reshape(-1)                           # [P * Ep]
    valid = part.edge_mask.reshape(-1) & graph.edge_valid[perm]
    xi, xj = poses[graph.edge_i[perm]], poses[graph.edge_j[perm]]
    meas, omega = graph.edge_meas[perm], graph.edge_info[perm]
    e = pgo_mod.edge_residual(xi, xj, meas)
    Ji, Jj = pgo_mod.edge_jacobians(xi, xj, meas)
    chi_e = (e * e * omega).sum(-1)
    if cfg.chi_threshold > 0:
        w = torch.where(chi_e < cfg.chi_threshold, torch.ones_like(chi_e),
                        cfg.chi_threshold / torch.clamp(chi_e, min=1e-20))
    else:
        w = torch.ones_like(chi_e)
    w = torch.where(valid, w, torch.zeros_like(w))
    wo = w[:, None] * omega

    # flat indices into the [P * n3 * n3] buffer of all local systems
    base = (torch.arange(P, device=dev) * (n3 * n3)).repeat_interleave(part.edges_per_part)
    ar = torch.arange(3, device=dev)
    li, lj = part.ei_local[perm], part.ej_local[perm]

    def flat(lr, lc):
        r = 3 * lr[:, None, None] + ar[None, :, None]
        c = 3 * lc[:, None, None] + ar[None, None, :]
        return (base[:, None, None] + r * n3 + c).reshape(-1)

    Hij = _block(Ji, wo, Jj)
    H = torch.zeros(P * n3 * n3, dtype=torch.float32, device=dev)
    H.index_add_(0, flat(li, li), _block(Ji, wo, Ji).reshape(-1))
    H.index_add_(0, flat(lj, lj), _block(Jj, wo, Jj).reshape(-1))
    H.index_add_(0, flat(li, lj), Hij.reshape(-1))
    H.index_add_(0, flat(lj, li), Hij.transpose(-1, -2).reshape(-1))
    bbase = (torch.arange(P, device=dev) * n3).repeat_interleave(part.edges_per_part)
    b = torch.zeros(P * n3, dtype=torch.float32, device=dev)
    b.index_add_(0, (bbase[:, None] + 3 * li[:, None] + ar).reshape(-1),
                 torch.einsum("eki,ek,ek->ei", Ji, wo, e).reshape(-1))
    b.index_add_(0, (bbase[:, None] + 3 * lj[:, None] + ar).reshape(-1),
                 torch.einsum("eki,ek,ek->ei", Jj, wo, e).reshape(-1))

    # interior anchors / damping only (separator anchors enter the reduced
    # system once); pad slots get a unit diagonal, which keeps cond(H_ii)
    # float32-friendly, as do empty local separator slots
    anchor = torch.where(graph.var_fixed | ~graph.var_valid,
                         torch.full_like(poses[:, 0], cfg.anchor_weight),
                         torch.full_like(poses[:, 0], cfg.damping))
    own_anchor = torch.cat([anchor, anchor.new_zeros(1)])[
        torch.clamp(part.interior_idx, max=v_cap)]
    diag_add = torch.where(part.interior_idx >= v_cap, torch.ones_like(own_anchor), own_anchor)
    empty_sep = (part.sep_local_idx >= part.separator_cap).to(torch.float32)
    diag_all = torch.cat([diag_add, empty_sep], dim=1).repeat_interleave(3, dim=1)
    H = H.reshape(P, n3, n3)
    H.diagonal(dim1=-2, dim2=-1).add_(diag_all)
    chi = torch.where(valid, chi_e, torch.zeros_like(chi_e)).reshape(P, -1).sum(1)
    return H, b.reshape(P, n3), chi


def elimination_chunks(n_parts: int) -> int:
    """How many batched interior solves the elimination of ``n_parts``
    partitions takes: one below 512 partitions, else one per 256, which
    needs ``n_parts % 256 == 0`` (the reference's rule; it fails there too)."""
    if n_parts < 512:
        return 1
    if n_parts % ELIMINATION_CHUNK:
        raise ValueError(
            f"Schur elimination of {n_parts} >= 512 partitions runs in chunks of "
            f"{ELIMINATION_CHUNK}: it needs n_parts % {ELIMINATION_CHUNK} == 0")
    return n_parts // ELIMINATION_CHUNK


def _eliminate(Hp, bp, rows3, anchor_sep, d_i: int, d_s: int):
    """Interior elimination, reduced-system assembly and separator solve.
    The elimination uses backward-stable LU solves (Jacobi-scaled, finite
    guard), not explicit inverses: chain interiors have soft modes whose
    inverse-times-multiply error made the reduced system indefinite in the
    reference. One LU per partition serves both right-hand sides.

    Returns (dx_s [d_s], y [P, dI], G [P, dI, dL])."""
    H_ii = Hp[:, :d_i, :d_i]
    H_il = Hp[:, :d_i, d_i:]
    H_ll_p = Hp[:, d_i:, d_i:]
    b_i = bp[:, :d_i]
    b_l_p = bp[:, d_i:]
    d_l = H_il.shape[-1]
    rhs = torch.cat([H_il, b_i[..., None]], dim=-1)
    chunks = elimination_chunks(Hp.shape[0])
    X = torch.cat([pgo_mod.solve_spd_scaled_batched(h, r)
                   for h, r in zip(H_ii.chunk(chunks), rhs.chunk(chunks))])
    G, y = X[..., :d_l], X[..., d_l]
    S_loc = H_ll_p - torch.einsum("pji,pjk->pik", H_il, G)
    b_loc = b_l_p - torch.einsum("pji,pj->pi", H_il, y)
    # local -> global reduced system (scatter-add; pad rows land in row d_s)
    n = d_s + 1
    S_red = torch.zeros(n * n, dtype=torch.float32, device=Hp.device)
    S_red.index_add_(0, (rows3[:, :, None] * n + rows3[:, None, :]).reshape(-1),
                     S_loc.reshape(-1))
    S_red = S_red.reshape(n, n)[:d_s, :d_s] + torch.diag(anchor_sep.repeat_interleave(3))
    b_red = torch.zeros(n, dtype=torch.float32, device=Hp.device)
    b_red.index_add_(0, rows3.reshape(-1), b_loc.reshape(-1))
    return _solve_separator(S_red, -b_red[:d_s]), y, G


def _solve_separator(S_red: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense scaled LU up to ``DENSE_SEPARATOR_ROWS`` rows, else
    ``SEPARATOR_PCG_ITERATIONS`` iterations of Jacobi-PCG on the
    materialized system (no exit test: no host synchronisation)."""
    if S_red.shape[0] <= DENSE_SEPARATOR_ROWS:
        return pgo_mod.solve_spd_scaled(S_red, b)
    d = torch.clamp(torch.diagonal(S_red), min=1e-12)
    x = torch.zeros_like(b)
    r = b
    p = b / d
    rz = torch.dot(r, p)
    for _ in range(SEPARATOR_PCG_ITERATIONS):
        Sp = S_red @ p
        alpha = rz / torch.clamp(torch.dot(p, Sp), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Sp
        z = r / d
        rz_new = torch.dot(r, z)
        p = z + (rz_new / torch.clamp(rz, min=1e-30)) * p
        rz = rz_new
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def optimize_schur(cfg: PGOConfig, graph: PoseGraph, part: Partitioning,
                   stats: list | None = None):
    """GN loop with a Schur elimination per iteration and the divergence
    guard of ``pgo.optimize``. Same contract: (graph with solved poses, chi,
    iterations). ``stats``, where given, receives each iteration's chi."""
    elimination_chunks(part.n_parts)
    v_cap = graph.var_capacity
    P, I, S = part.n_parts, part.interior_cap, part.separator_cap
    d_i, d_s, d_l = 3 * I, 3 * S, 3 * part.sep_local_cap
    dev = graph.poses.device
    # [P, dL] global row of each local separator row (pad -> d_s, dropped)
    rows3 = torch.clamp(3 * part.sep_local_idx[:, :, None]
                        + torch.arange(3, device=dev)[None, None, :], max=d_s).reshape(P, d_l)
    sep_g = torch.clamp(part.separator_idx, max=v_cap)
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    anchored = ((part.separator_idx >= v_cap) | torch.cat([graph.var_fixed, no])[sep_g]
                | ~torch.cat([graph.var_valid, no])[sep_g])
    anchor_sep = torch.where(anchored, cfg.anchor_weight, cfg.damping).to(torch.float32)
    movable = (graph.var_valid & ~graph.var_fixed)[:, None]
    poses = graph.poses
    it, chi, chi_prev = 0, float("inf"), float("inf")
    chi_t = torch.tensor(chi)
    while it < cfg.max_iterations and not (it > 1 and decayed(chi, chi_prev, cfg.epsilon)):
        Hp, bp, chi_p = _partition_systems(cfg, graph, part, poses)
        chi_t = chi_p.sum()
        dx_s, y, G = _eliminate(Hp, bp, rows3, anchor_sep, d_i, d_s)
        dx_sl = torch.cat([dx_s, dx_s.new_zeros(1)])[rows3]           # [P, dL]
        dx_i = -y - torch.einsum("pik,pk->pi", G, dx_sl)              # [P, dI]
        dx = torch.zeros(v_cap + 1, 3, dtype=torch.float32, device=dev)
        dx.index_add_(0, part.interior_idx.reshape(-1), dx_i.reshape(P * I, 3))
        dx.index_add_(0, part.separator_idx, dx_s.reshape(S, 3))
        dx = torch.where(movable, dx[:v_cap], torch.zeros_like(poses))
        cand = geometry.compose(dx, poses)
        # divergence guard: keep the poses where the float32 elimination of
        # a chain's soft modes returned a step whose chi explodes
        chi_cand = pgo_mod.graph_chi(graph, cand)
        ok = torch.isfinite(chi_cand) & (chi_cand <= 1e3 * chi_t + 1e3)
        poses = torch.where(ok, cand, poses)
        chi_prev, chi = chi, float(chi_t)
        if stats is not None:
            stats.append({"chi": chi})
        it += 1
    return graph._replace(poses=poses), chi_t, it
