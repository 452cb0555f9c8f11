"""Loop-closing stack: candidate selection, detector gates, the vote-based
closure validator and closure-time map fusion. Counterpart of
``srrg2_laser_slam_2d_tpu/models/loop_closure.py``. The chunked loop aligns
its candidates through the NN-ICP kernel
(``ops/nn_icp_kernel.fused_align_pairs``, the ``fused_nn`` backend) or, on
the default ``projective`` backend, through one batched projective ICP over
all its pairs (``_batch_align_pairs``); the per-message loop's
``BruteForceLoopDetector.detect`` aligns the query scene against all its
candidates in one batched projective ICP (``_batch_align``).
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..ops import icp
from ..ops import merge as merge_op
from ..ops import projector as projector_op
from ..ops.projector import PolarProjection
from ..solver import pgo
from ..utils import cloud as cloud_op
from ..utils import profiling
from ..utils.cloud import Cloud

# ``BreadthFirstSelector.select_many``: calls, breadth-first levels run and
# (query, neighbour) pairs gathered before the distance filter, always on
select_calls = 0
select_levels = 0
select_expansions = 0


def relative_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host-side SE(2) relative pose a^-1 b (angle not wrapped)."""
    c, s = np.cos(a[2]), np.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    return np.array([c * dx + s * dy, -s * dx + c * dy, b[2] - a[2]], np.float32)


def compose_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host-side SE(2) composition a b (angle not wrapped)."""
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * b[0] - s * b[1], a[1] + s * b[0] + c * b[1],
                     a[2] + b[2]], np.float32)


def default_ld_aligner() -> icp.AlignerConfig:
    """Loop-detection aligner: 30 iterations, point distance 1.414, normal
    cos 0.8, Cauchy 0.05, no odometry prior."""
    return icp.AlignerConfig(max_iterations=30, min_num_inliers=10,
                             point_distance=1.414, normal_cos=0.8,
                             chi_threshold=0.05, odom_weight=0.0)


@dataclass(frozen=True)
class LoopDetectorConfig:
    """MultiLoopDetectorBruteForce2D + LocalMapSelectorBreadthFirst2D."""

    relocalize_min_inliers: int = 300
    relocalize_min_inliers_ratio: float = 0.8
    relocalize_max_chi_inliers: float = 0.1
    max_local_map_distance: float = 1.0
    relocalize_range_scale: float = 2.0
    aggressive_relocalize_graph_distance: int = 10
    aggressive_relocalize_graph_max_range: int = 20
    aggressive_relocalize_range_increase_per_edge: float = 0.05
    max_candidates: int = 8
    aligner: icp.AlignerConfig = field(default_factory=default_ld_aligner)
    backend: str = "projective"
    # point capacity the chunked loop aligns scenes at (0 = no cap)
    detection_capacity: int = 0
    # NN-ICP correspondence refresh period
    fused_corr_refresh: int = 1


@dataclass(frozen=True)
class ValidatorConfig:
    """FactorGraphClosureValidator."""

    inlier_accept_ratio: float = 0.5
    inlier_reject_ratio: float = 0.3
    inlier_chi: float = 0.05
    min_times_checked: int = 3
    partition_expansion_range: int = 8
    enabled: bool = True


@dataclass(frozen=True)
class RelocalizerConfig:
    """MultiRelocalizer2D."""

    max_translation: float = 3.0
    relocalize_max_chi_inliers: float = 0.005
    relocalize_min_inliers: int = 500
    relocalize_min_inliers_ratio: float = 0.7


@dataclass
class ClosureCandidate:
    query_map: int
    candidate_map: int
    estimate: np.ndarray       # pose of the query map in the candidate map
    num_inliers: int
    num_correspondences: int
    chi_inliers: float


def _batch_align(acfg: icp.AlignerConfig, proj: PolarProjection, fixed_batch: Cloud,
                 moving: Cloud, initials: torch.Tensor) -> icp.AlignResult:
    """Align the query scene ``moving`` [N, ...] against K candidate scenes
    ``fixed_batch`` [K, N, ...] at once (``icp.align`` over a batch)."""
    return icp.align(acfg, proj, fixed_batch, moving, initials)


def _batch_align_pairs(acfg: icp.AlignerConfig, proj: PolarProjection, fixed_batch: Cloud,
                       moving_batch: Cloud, initials: torch.Tensor) -> icp.AlignResult:
    """Align J independent (query, candidate) scene pairs at once: the query
    scenes ``moving_batch`` [J, N, ...] against the candidate scenes
    ``fixed_batch`` [J, N, ...] from ``initials`` [J, 3] (the chunked loop's
    ``projective`` detector backend)."""
    return icp.align(acfg, proj, fixed_batch, moving_batch, initials)


def graph_distances(adjacency: list[set[int]], start: int) -> dict[int, int]:
    """Breadth-first distances over the local-map graph."""
    dist = {start: 0}
    q = deque([start])
    while q:
        u = q.popleft()
        for v in adjacency[u]:
            if v not in dist:
                dist[v] = dist[u] + 1
                q.append(v)
    return dist


def merge_closure_scenes(proj: PolarProjection, fixed: Cloud, moving: Cloud,
                         query_in_candidate: torch.Tensor,
                         point_distance: float = 0.5, normal_cos: float = 0.8,
                         max_distance2: float = 0.25, target_merges: int = 200,
                         binning: bool = True) -> Cloud:
    """Fuse J query scenes into their candidate scenes ([J, cap, ...] each,
    estimates [J, 3]): projective correspondences from the candidate's
    canvas, then ``merge_correspondence``."""
    canvas = projector_op.project_local(proj, fixed)
    corr = icp.find_projective(proj, canvas, fixed, moving, query_in_candidate,
                               point_distance, normal_cos)
    return merge_op.merge_correspondence(
        fixed, moving, corr.fixed_idx, corr.moving_idx, corr.valid,
        query_in_candidate, maximum_distance_geometry_squared=max_distance2,
        target_number_of_merges=target_merges, enable_binning=binning)


class BreadthFirstSelector:
    """Candidate local maps for closure checks: graph distance plus a
    Euclidean gate that widens when the graph detour is long."""

    def __init__(self, cfg: LoopDetectorConfig):
        self.cfg = cfg

    def select(self, query: int, poses: np.ndarray, n_maps: int,
               adjacency: list[set[int]]) -> list[int]:
        """Candidate maps of one query, nearest first."""
        cfg = self.cfg
        dist = graph_distances(adjacency, query)
        q_xy = poses[query, :2]
        out = []
        for m in range(n_maps):
            gd = dist.get(m, 10**9)
            if m == query or gd <= 1:
                continue      # direct neighbours are not closures
            rng = cfg.max_local_map_distance * cfg.relocalize_range_scale
            if gd >= cfg.aggressive_relocalize_graph_distance:
                rng += (min(gd, cfg.aggressive_relocalize_graph_max_range)
                        * cfg.aggressive_relocalize_range_increase_per_edge)
            d = float(np.linalg.norm(poses[m, :2] - q_xy))
            if d <= rng:
                out.append((d, m))
        out.sort()
        return [m for _, m in out[: cfg.max_candidates]]

    def select_many(self, queries: list[int], poses: np.ndarray, n_maps: int,
                    adjacency: list[set[int]]) -> list[tuple[int, int]]:
        """(query, candidate) jobs for every query, nearest first: one
        level-synchronous breadth-first search for all Q queries at once,
        over a CSR form of the adjacency, its frontier a flat array of
        ``query row * M + node`` keys (work follows the edges the frontier
        touches, not Q * M^2)."""
        global select_calls, select_levels, select_expansions
        select_calls += 1
        cfg = self.cfg
        Q = len(queries)
        if Q == 0 or n_maps == 0:
            return []
        M = n_maps
        rows = [[j for j in nbrs if j < M] for nbrs in adjacency[:M]]
        deg = np.zeros(M, np.int64)
        deg[:len(rows)] = [len(r) for r in rows]
        indptr = np.zeros(M + 1, np.int64)
        np.cumsum(deg, out=indptr[1:])
        indices = np.fromiter(itertools.chain.from_iterable(rows), np.int64,
                              count=int(indptr[-1]))
        max_d = max(cfg.aggressive_relocalize_graph_max_range, 2) + 1
        dist = np.full((Q, M), 1 << 30, np.int64)
        flat = dist.reshape(-1)
        qrow = np.arange(Q, dtype=np.int64)
        node = np.asarray(queries, np.int64)
        dist[qrow, node] = 0
        for level in range(1, max_d + 1):
            out = deg[node]
            n = int(out.sum())
            # each frontier row's out-edges, laid end to end
            start = np.repeat(indptr[node] - (np.cumsum(out) - out), out)
            keys = np.repeat(qrow, out) * M + indices[start + np.arange(n)]
            select_levels += 1
            select_expansions += n
            keys = np.unique(keys[flat[keys] > level])
            if keys.size == 0:
                break
            flat[keys] = level
            qrow, node = np.divmod(keys, M)
        gd = np.minimum(dist, 10**9)
        rng = np.full((Q, M), cfg.max_local_map_distance * cfg.relocalize_range_scale)
        widen = gd >= cfg.aggressive_relocalize_graph_distance
        rng = rng + np.where(
            widen,
            np.minimum(gd, cfg.aggressive_relocalize_graph_max_range)
            * cfg.aggressive_relocalize_range_increase_per_edge, 0.0)
        q_xy = poses[queries, :2]
        d = np.linalg.norm(poses[None, :M, :2] - q_xy[:, None, :], axis=2)
        ok = (gd > 1) & (d <= rng)
        ok[np.arange(Q), queries] = False
        jobs: list[tuple[int, int]] = []
        for qi, q in enumerate(queries):
            cand = np.where(ok[qi])[0]
            if len(cand) == 0:
                continue
            order = cand[np.argsort(d[qi, cand], kind="stable")]
            jobs.extend((q, int(m)) for m in order[: cfg.max_candidates])
        return jobs


def gate_candidates(cfg: LoopDetectorConfig, jobs: list[tuple[int, int]],
                    n_inl: np.ndarray, n_cor: np.ndarray, chi_in: np.ndarray,
                    est: np.ndarray) -> list[ClosureCandidate]:
    """Detector acceptance gates on batched alignment results."""
    out = []
    for k, (q, m) in enumerate(jobs):
        if n_inl[k] < cfg.relocalize_min_inliers:
            continue
        if n_cor[k] == 0 or n_inl[k] / max(int(n_cor[k]), 1) < cfg.relocalize_min_inliers_ratio:
            continue
        if chi_in[k] > cfg.relocalize_max_chi_inliers:
            continue
        out.append(ClosureCandidate(
            query_map=q, candidate_map=m, estimate=est[k],
            num_inliers=int(n_inl[k]), num_correspondences=int(n_cor[k]),
            chi_inliers=float(chi_in[k])))
    return out


class BruteForceLoopDetector:
    """The detector configuration, its candidate selector, the per-message
    ``detect`` and its many-query form ``detect_many``. The chunked loop
    aligns the selected pairs itself (in batches of pairs) and gates them
    with ``gate_candidates``."""

    def __init__(self, cfg: LoopDetectorConfig, proj: PolarProjection):
        self.cfg = cfg
        self.proj = proj
        self.selector = BreadthFirstSelector(cfg)

    def detect(self, query: int, scenes: list[Cloud], poses: np.ndarray, n_maps: int,
               adjacency: list[set[int]]) -> list[ClosureCandidate]:
        """Align the query map's scene against all its selected candidates
        in one batched projective ICP, then gate."""
        cands = self.selector.select(query, poses, n_maps, adjacency)
        if not cands:
            return []
        # scenes differ in capacity once one has grown: repad to the largest
        maxcap = max(scenes[m].capacity for m in cands)
        batch = [scenes[m] if scenes[m].capacity == maxcap
                 else cloud_op.repad(scenes[m], maxcap) for m in cands]
        fixed = Cloud(*(torch.stack(f) for f in zip(*batch)))
        moving = scenes[query]
        initials = np.stack([relative_np(poses[m], poses[query]) for m in cands])
        res = _batch_align(self.cfg.aligner, self.proj, fixed, moving,
                           torch.from_numpy(initials).to(moving.xy.device))
        packed = torch.cat([res.num_inliers[:, None].to(torch.float32),
                            res.num_correspondences[:, None].to(torch.float32),
                            res.chi_inliers[:, None], res.estimate], dim=1).cpu().numpy()
        return gate_candidates(self.cfg, [(query, m) for m in cands], packed[:, 0],
                               packed[:, 1], packed[:, 2], packed[:, 3:6])

    def detect_many(self, queries: list[int], scenes: list[Cloud], poses: np.ndarray,
                    n_maps: int, adjacency: list[set[int]], pad_to: int = 8,
                    capacity: int | None = None) -> list[ClosureCandidate]:
        """``detect`` for several query maps as one batched alignment and one
        read of the results. The jobs are padded with copies of the first to
        a power of two (at least ``pad_to``); ``capacity`` aligns at that
        point capacity instead of the scenes' largest (larger scenes are cut
        to their first ``capacity`` rows, smaller ones padded)."""
        jobs = [(q, m) for q in queries
                for m in self.selector.select(q, poses, n_maps, adjacency)]
        if not jobs:
            return []
        J = pad_to
        while J < len(jobs):
            J *= 2
        padded = jobs + [jobs[0]] * (J - len(jobs))
        cap = capacity or max(max(scenes[m].capacity for _, m in padded),
                              max(scenes[q].capacity for q, _ in padded))

        def at_cap(c: Cloud) -> Cloud:
            if c.capacity >= cap:
                return c.map(lambda x: x[:cap])
            return cloud_op.repad(c, cap)

        fixed = cloud_op.stack([at_cap(scenes[m]) for _, m in padded])
        moving = cloud_op.stack([at_cap(scenes[q]) for q, _ in padded])
        initials = np.stack([relative_np(poses[m], poses[q]) for q, m in padded])
        res = _batch_align_pairs(self.cfg.aligner, self.proj, fixed, moving,
                                 torch.from_numpy(initials).to(fixed.xy.device))
        packed = torch.cat([res.num_inliers[:, None].to(torch.float32),
                            res.num_correspondences[:, None].to(torch.float32),
                            res.chi_inliers[:, None], res.estimate], dim=1).cpu().numpy()
        return gate_candidates(self.cfg, jobs, packed[:, 0], packed[:, 1], packed[:, 2],
                               packed[:, 3:6])


class ClosureValidator:
    """Vote-based closure acceptance (FactorGraphClosureValidator).

    Each round grows a partition of ``partition_expansion_range`` BFS hops
    around every pending closure, merges overlapping partitions, solves each
    partition with its trial closures (Cauchy at ``inlier_chi``, gauge at
    its first variable) and counts a vote for every closure whose
    information-weighted residual falls below ``inlier_chi``. After
    ``min_times_checked`` rounds the vote ratio accepts or rejects. Each
    partition's solve is the span ``slam.vote.solve``, its seconds added to
    ``times["vote.solve"]`` (the owning loop's ``phase_times``)."""

    def __init__(self, cfg: ValidatorConfig, closure_info=(100.0, 100.0, 1000.0),
                 device=None, times: dict | None = None):
        self.cfg = cfg
        self.closure_info = np.asarray(closure_info, np.float32)
        self.device = resolve_device(device)
        self.times = times
        self.pending: list[dict] = []

    def add(self, closure: ClosureCandidate) -> None:
        self.pending.append({"closure": closure, "checks": 0, "votes": 0})

    def _expand(self, adjacency: list[set[int]], seeds: list[int]) -> set[int]:
        dist = {s: 0 for s in seeds}
        q = deque(seeds)
        rng = self.cfg.partition_expansion_range
        while q:
            u = q.popleft()
            if dist[u] >= rng:
                continue
            for v in adjacency[u]:
                if v not in dist:
                    dist[v] = dist[u] + 1
                    q.append(v)
        return set(dist)

    def _partitions(self, adjacency):
        merged: list[tuple[set[int], list[dict]]] = []
        for p in self.pending:
            c: ClosureCandidate = p["closure"]
            vars_ = self._expand(adjacency, [c.query_map, c.candidate_map])
            hit = next((m for m in merged if m[0] & vars_), None)
            if hit is None:
                merged.append((set(vars_), [p]))
            else:
                hit[0].update(vars_)
                hit[1].append(p)
        return merged

    def _check_partition(self, vars_, entries, poses, graph_edges) -> None:
        order = sorted(vars_)
        local = {g: i for i, g in enumerate(order)}
        sub_edges = [(local[i], local[j], m, w) for (i, j, m, w) in graph_edges
                     if i in vars_ and j in vars_]
        closure_rows = [(local[p["closure"].candidate_map],
                         local[p["closure"].query_map], p["closure"].estimate)
                        for p in entries]
        nv = len(order)
        vc = pgo.round_capacity(nv)
        ec = pgo.round_capacity(max(len(sub_edges) + len(closure_rows), 1))
        sub_poses = np.zeros((vc, 3), np.float32)
        sub_poses[:nv] = poses[order]
        ei, ej = np.zeros(ec, np.int64), np.zeros(ec, np.int64)
        meas = np.zeros((ec, 3), np.float32)
        info = np.ones((ec, 3), np.float32)
        valid = np.zeros(ec, bool)
        for k, (i, j, m, w) in enumerate(sub_edges):
            ei[k], ej[k], meas[k], info[k], valid[k] = i, j, m, w, True
        for k, (i, j, m) in enumerate(closure_rows, start=len(sub_edges)):
            ei[k], ej[k], meas[k], valid[k] = i, j, m, True
            info[k] = self.closure_info
        var_valid = np.arange(vc) < nv
        var_fixed = np.arange(vc) == 0
        with profiling.timed("slam.vote.solve", times=self.times, key="vote.solve"):
            g = pgo.graph_from_numpy(sub_poses, var_valid, var_fixed, ei, ej, meas,
                                     info, valid, device=self.device)
            solved, _, _ = pgo.optimize(
                pgo.PGOConfig(max_iterations=10, chi_threshold=self.cfg.inlier_chi), g)
            opt = solved.poses.cpu().numpy()
        for p, (i, j, m) in zip(entries, closure_rows):
            e = compose_np(
                np.array([-np.cos(m[2]) * m[0] - np.sin(m[2]) * m[1],
                          np.sin(m[2]) * m[0] - np.cos(m[2]) * m[1], -m[2]],
                         np.float32),
                relative_np(opt[i], opt[j]))
            e[2] = (e[2] + np.pi) % (2 * np.pi) - np.pi
            chi = float(np.sum(e * e * self.closure_info))
            p["checks"] += 1
            if chi < self.cfg.inlier_chi:
                p["votes"] += 1

    def vote(self, poses: np.ndarray, adjacency: list[set[int]],
             graph_edges: list) -> list[ClosureCandidate]:
        """One voting round; returns the newly accepted closures."""
        if not self.cfg.enabled:
            out = [p["closure"] for p in self.pending]
            self.pending.clear()
            return out
        if not self.pending:
            return []
        for vars_, entries in self._partitions(adjacency):
            self._check_partition(vars_, entries, poses, graph_edges)
        accepted, still = [], []
        for p in self.pending:
            if p["checks"] >= self.cfg.min_times_checked:
                ratio = p["votes"] / p["checks"]
                if ratio >= self.cfg.inlier_accept_ratio:
                    accepted.append(p["closure"])
                elif ratio >= self.cfg.inlier_reject_ratio:
                    still.append(p)
            else:
                still.append(p)
        self.pending = still
        return accepted
