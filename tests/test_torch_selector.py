"""The chunked loop's candidate selection
(``srrg2_laser_slam_2d_tpu_torch/models/loop_closure.py``:
``BreadthFirstSelector.select_many``, a sparse level-synchronous
breadth-first search over a CSR form of the local-map adjacency) against the
JAX package's ``select_many`` (a dense boolean ``[Q, M] @ [M, M]`` product a
level, NumPy in both packages): the job list must be equal, element for
element and in order, on every graph. Then the counters ``select_calls``,
``select_levels`` and ``select_expansions`` against a per-query walk
(``graph_distances``): the levels run are those until the frontier empties
or the ``max_d`` cut, the expansions the frontier rows' out-degrees summed
over those levels."""

import numpy as np
import pytest

from srrg2_laser_slam_2d_tpu.models import loop_closure as jlc
from srrg2_laser_slam_2d_tpu_torch.models import loop_closure as tlc

CFG = dict(max_candidates=8)


def _link(adjacency, i, j):
    adjacency[i].add(j)
    adjacency[j].add(i)


def _chain(m: int, closures: int, seed: int, step: float = 0.5):
    """A chain of ``m`` maps along a random walk of ``step`` metres, with
    ``closures`` seeded links between maps that lie within 3 m."""
    rng = np.random.default_rng(seed)
    heading = np.cumsum(rng.normal(0.0, 0.6, m))
    xy = np.cumsum(step * np.stack([np.cos(heading), np.sin(heading)], 1), 0)
    poses = np.concatenate([xy, heading[:, None]], 1).astype(np.float32)
    adjacency = [set() for _ in range(m)]
    for i in range(m - 1):
        _link(adjacency, i, i + 1)
    near = np.argwhere(np.linalg.norm(xy[:, None] - xy[None], axis=2) < 3.0)
    near = near[near[:, 1] > near[:, 0] + 1]
    for i, j in near[rng.permutation(len(near))[:closures]]:
        _link(adjacency, int(i), int(j))
    return poses, adjacency


def _graph(case: str):
    """(queries, poses, n_maps, adjacency) of one named case."""
    if case.startswith("chain"):
        m, q = {"chain130": (130, 50), "chain400": (400, 130), "chain2000": (2000, 16)}[case]
        poses, adj = _chain(m, m // 20, seed=m)
        return list(range(m - q, m)), poses, m, adj
    if case == "two_components":
        pa, aa = _chain(40, 3, seed=1)
        pb, ab = _chain(40, 3, seed=2)
        adj = aa + [{j + 40 for j in s} for s in ab]
        # the second component lies over the first: near in space, unreached
        return [5, 20, 45, 70], np.concatenate([pa, pb]), 80, adj
    if case == "long_chain":
        # 70 maps round a 1.2 m circle: every map near every other, the far
        # end of the chain past the 21-level cut and the widening cap
        t = np.linspace(0, 2 * np.pi, 70, endpoint=False)
        poses = np.stack([1.2 * np.cos(t), 1.2 * np.sin(t), t], 1).astype(np.float32)
        adj = [set() for _ in range(70)]
        for i in range(69):
            _link(adj, i, i + 1)
        return [0, 10, 35, 69], poses, 70, adj
    if case == "indices_past_n_maps":
        poses, adj = _chain(60, 4, seed=7)
        adj = adj + [set() for _ in range(5)]
        for i, extra in ((3, 60), (20, 64), (45, 61), (59, 62)):
            _link(adj, i, extra)
        _link(adj, 60, 10)
        return [30, 45, 59], np.concatenate([poses, np.zeros((5, 3), np.float32)]), 60, adj
    if case == "short_adjacency":
        poses, adj = _chain(50, 3, seed=8)
        return [20, 30, 35], poses, 50, adj[:40]
    if case == "no_candidates":
        poses, adj = _chain(30, 2, seed=9)
        poses[29, :2] = (100.0, 100.0)    # far from all, its only link a neighbour
        return [10, 29], poses, 30, adj
    if case == "single_query":
        poses, adj = _chain(130, 6, seed=10)
        return [77], poses, 130, adj
    if case == "tied_distances":
        # a 9 x 9 grid of maps 0.5 m apart, linked as a snake: many
        # candidates at equal distances, more than max_candidates of them
        g = np.array([(x, y if x % 2 == 0 else 8 - y) for x in range(9) for y in range(9)])
        poses = np.concatenate([0.5 * g, np.zeros((81, 1))], 1).astype(np.float32)
        adj = [set() for _ in range(81)]
        for i in range(80):
            _link(adj, i, i + 1)
        return [40, 0, 44, 80], poses, 81, adj
    if case == "directed_edge":
        poses, adj = _chain(60, 0, seed=11, step=0.3)
        poses[50, :2] = poses[5, :2] + (0.05, 0.0)
        adj[5].add(50)                    # 5 -> 50 only
        return [5, 50, 30], poses, 60, adj
    raise ValueError(case)


CASES = ["chain130", "chain400", "chain2000", "two_components", "long_chain",
         "indices_past_n_maps", "short_adjacency", "no_candidates", "single_query",
         "tied_distances", "directed_edge"]


@pytest.mark.parametrize("case", CASES)
def test_select_many_matches_reference(case):
    queries, poses, n_maps, adj = _graph(case)
    got = tlc.BreadthFirstSelector(tlc.LoopDetectorConfig(**CFG)).select_many(
        queries, poses, n_maps, adj)
    want = jlc.BreadthFirstSelector(jlc.LoopDetectorConfig(**CFG)).select_many(
        queries, poses, n_maps, adj)
    assert got == want
    assert got, "every case selects some job"
    by_query = {q: [m for qq, m in got if qq == q] for q in queries}
    if case == "no_candidates":
        assert by_query[29] == []
    if case == "tied_distances":
        # equal distances in index order (stable argsort), and the cut to
        # max_candidates falls inside a group of ties
        d = np.linalg.norm(poses[:, :2] - poses[40, :2], axis=1)
        kept = by_query[40]
        assert len(kept) == CFG["max_candidates"]
        assert kept == sorted(kept, key=lambda m: (d[m], m))
        assert np.sum(d == d[kept[-1]]) > sum(d[m] == d[kept[-1]] for m in kept)
    if case == "directed_edge":
        assert 50 not in by_query[5] and 5 in by_query[50]


def _expected_counts(cfg, queries, n_maps, adj):
    """Levels and expansions of one ``select_many`` call from a per-query
    walk: level L expands the maps at distance L - 1 of every query."""
    max_d = max(cfg.aggressive_relocalize_graph_max_range, 2) + 1
    out_deg = [sum(j < n_maps for j in adj[i]) if i < len(adj) else 0
               for i in range(n_maps)]
    sub = [set(j for j in adj[i] if j < n_maps) if i < len(adj) else set()
           for i in range(n_maps)]
    dists = [{m: g for m, g in tlc.graph_distances(sub, q).items() if g <= max_d}
             for q in queries]
    levels = min(max_d, max(max(d.values()) for d in dists) + 1)
    expansions = sum(out_deg[m] for d in dists for m, g in d.items() if g < levels)
    return levels, expansions


@pytest.mark.parametrize("case", ["chain400", "long_chain", "two_components",
                                  "indices_past_n_maps", "directed_edge"])
def test_select_counters(case):
    queries, poses, n_maps, adj = _graph(case)
    cfg = tlc.LoopDetectorConfig(**CFG)
    sel = tlc.BreadthFirstSelector(cfg)
    max_d = max(cfg.aggressive_relocalize_graph_max_range, 2) + 1
    calls, levels, exp = tlc.select_calls, tlc.select_levels, tlc.select_expansions
    sel.select_many(queries, poses, n_maps, adj)
    want_levels, want_exp = _expected_counts(cfg, queries, n_maps, adj)
    assert tlc.select_calls - calls == 1
    assert tlc.select_levels - levels == want_levels <= max_d
    assert tlc.select_expansions - exp == want_exp
    if case == "long_chain":
        assert want_levels == max_d       # the cut, not an empty frontier, ends it
    sel.select_many([], poses, n_maps, adj)
    assert tlc.select_calls - calls == 2 and tlc.select_levels - levels == want_levels
