"""City-scale pose-graph benchmark: a synthetic multi-session grid-world
graph of up to 1M+ nodes (the fifth configuration of ``BASELINE.json``)
solved with the matrix-free PCG Gauss-Newton (``solver/cg.py``).
Counterpart of ``srrg2_laser_slam_2d_tpu/bench/pgo_bench.py``; the same
seed gives the same graph in both packages.

    python -m srrg2_laser_slam_2d_tpu_torch.bench.pgo_bench 1024

runs a 1,048,576-node lattice on the card (``--device cpu`` rehearses a
small side on the host).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import card_description, resolve_device
from ..solver import cg, pgo
from ..utils import geometry

LARGE_NODES = 100_000     # above: sorted segment sums and chunked linearization
EDGE_CHUNK = 131072       # jac_chunk and edge-capacity alignment of large graphs


@dataclass
class PGOBenchResult:
    nodes: int
    edges: int
    chi0: float
    chi1: float
    seconds_per_gn_iteration: float
    iterations: int
    chi_per_iteration: list = field(default_factory=list)
    cg_iterations: list = field(default_factory=list)
    peak_device_bytes: int | None = None
    finite: bool = True     # every solved pose finite
    device: str = "cpu"     # the card's name and power limit, or "cpu"


def _relative_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return geometry.relative(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def _graph(n: int, e: int, v_cap: int, e_cap: int, init, ei, ej, meas, device):
    poses = np.zeros((v_cap, 3), np.float32)
    poses[:n] = init
    var_fixed = np.zeros(v_cap, bool)
    var_fixed[0] = True
    pad = np.zeros(e_cap - e, np.int64)
    meas_p = np.zeros((e_cap, 3), np.float32)
    meas_p[:e] = meas
    return pgo.graph_from_numpy(
        poses, np.arange(v_cap) < n, var_fixed, np.concatenate([ei, pad]),
        np.concatenate([ej, pad]), meas_p, np.ones((e_cap, 3), np.float32),
        np.arange(e_cap) < e, device=device)


def make_grid_graph(side: int, noise: float = 0.02, closure_every: int = 8, seed: int = 0,
                    edge_align: int | None = None, device="cpu") -> pgo.PoseGraph:
    """side x side lattice graph with noisy edges and periodic long closures.
    ``edge_align`` (the edge-capacity alignment) must equal the solver's
    ``jac_chunk`` where chunked linearization is used (``run`` takes both
    from one decision), else the chunking silently turns off."""
    rng = np.random.default_rng(seed)
    v = side * side
    cols = np.arange(side, dtype=np.float32)
    gx, gy = np.meshgrid(cols, cols)
    gt = np.stack([gx.ravel(), gy.ravel(), np.zeros(v, np.float32)], axis=1)
    # right and down neighbours, plus sparse diagonal closures
    idx = np.arange(v).reshape(side, side)
    ei = [idx[:, :-1].ravel(), idx[:-1, :].ravel()]
    ej = [idx[:, 1:].ravel(), idx[1:, :].ravel()]
    if closure_every > 1:
        ci = idx[::closure_every, ::closure_every]
        ei.append(ci[:-1, :-1].ravel())
        ej.append(ci[1:, 1:].ravel())
    ei = np.concatenate(ei).astype(np.int64)
    ej = np.concatenate(ej).astype(np.int64)
    e = len(ei)
    meas = _relative_np(gt[ei], gt[ej]) + rng.normal(scale=noise, size=(e, 3)).astype(np.float32)
    init = gt + rng.normal(scale=0.1, size=(v, 3)).astype(np.float32)
    init[0] = gt[0]

    def up(x, m):
        return ((x + m - 1) // m) * m

    em = edge_align if edge_align is not None else (EDGE_CHUNK if v > LARGE_NODES else 16)
    return _graph(v, e, up(v, 16), up(e, em), init, ei, ej, meas, device)


def make_chain_graph(n: int, noise: float = 0.02, closure_every: int = 50,
                     closure_span: int = 40, seed: int = 0, device="cpu") -> pgo.PoseGraph:
    """Multi-session SLAM-shaped graph: a long odometry chain with periodic
    short-range closures (every ``closure_every`` nodes, back
    ``closure_span``). Index-range partitions of this shape have O(P)
    separators: the geometry the Schur solver is built for."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32) * 0.5
    gt = np.stack([t, 2.0 * np.sin(t * 0.05), np.zeros(n, np.float32)], 1)
    ci = np.arange(closure_span + closure_every, n, closure_every)
    ei = np.concatenate([np.arange(n - 1), ci]).astype(np.int64)
    ej = np.concatenate([np.arange(1, n), ci - closure_span]).astype(np.int64)
    e = len(ei)
    meas = _relative_np(gt[ei], gt[ej]) + rng.normal(scale=noise, size=(e, 3)).astype(np.float32)
    init = gt + rng.normal(scale=0.1, size=(n, 3)).astype(np.float32)
    init[0] = gt[0]
    return _graph(n, e, ((n + 15) // 16) * 16, ((e + 15) // 16) * 16, init, ei, ej, meas,
                  device)


def edge_chi(graph: pgo.PoseGraph, chunk: int = EDGE_CHUNK) -> float:
    """Edge-wise chi2 from residuals alone (no Jacobians), summed over edge
    chunks so the temporaries stay bounded at city scale."""
    ec = graph.edge_capacity
    step = chunk if chunk and ec > chunk and ec % chunk == 0 else ec
    parts = []
    for c0 in range(0, ec, step):
        sl = slice(c0, c0 + step)
        xi, xj = graph.poses[graph.edge_i[sl]], graph.poses[graph.edge_j[sl]]
        e = pgo.edge_residual(xi, xj, graph.edge_meas[sl])
        chi_e = (e * e * graph.edge_info[sl]).sum(-1)
        parts.append(torch.where(graph.edge_valid[sl], chi_e, torch.zeros_like(chi_e)).sum())
    return float(torch.stack(parts).sum())


def run(side: int = 64, gn_iterations: int = 5, cg_iterations: int = 50, reps: int = 3,
        large: bool | None = None, device=None) -> PGOBenchResult:
    """Build the side x side lattice on the device, solve it once (warm-up,
    its per-iteration chi kept), then ``reps`` times timed."""
    dev = resolve_device(device)
    if large is None:
        large = side * side > LARGE_NODES
    graph = make_grid_graph(side, edge_align=EDGE_CHUNK if large else 16, device=dev)
    order = cg.prepare_edge_order(graph) if large else None
    cfg = cg.CGConfig(gn_iterations=gn_iterations, cg_iterations=cg_iterations,
                      jac_chunk=EDGE_CHUNK if large else 0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    chi0 = edge_chi(graph)
    stats: list[dict] = []
    cg.optimize_cg(cfg, graph, order, stats=stats)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out, chi, it = cg.optimize_cg(cfg, graph, order)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - t0) / reps
    chi1 = edge_chi(out)
    return PGOBenchResult(
        nodes=side * side, edges=int(graph.edge_valid.sum()), chi0=chi0, chi1=chi1,
        seconds_per_gn_iteration=dt / max(it, 1), iterations=it,
        chi_per_iteration=[s["chi"] for s in stats],
        cg_iterations=[s["cg_iterations"] for s in stats],
        peak_device_bytes=(torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
        finite=bool(torch.isfinite(out.poses).all()),
        device=card_description(dev))


def main(argv=None) -> int:
    import argparse
    import json
    from dataclasses import asdict

    ap = argparse.ArgumentParser(description="City-scale pose-graph solve (matrix-free PCG).")
    ap.add_argument("side", type=int, nargs="?", default=64)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' rehearses")
    args = ap.parse_args(argv)
    r = run(args.side, device=args.device)
    print(f"nodes={r.nodes} edges={r.edges} chi {r.chi0:.1f}->{r.chi1:.1f} "
          f"{r.seconds_per_gn_iteration * 1000:.1f} ms/GN-iter ({r.iterations} iters) "
          f"on {r.device}")
    print(json.dumps(asdict(r)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
