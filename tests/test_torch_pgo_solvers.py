"""The port's large-graph pose-graph solvers against the JAX package on the
CPU, on the graphs of tests/test_pgo.py, tests/test_cg.py and
tests/test_schur.py and on the city-scale generators of ``bench/pgo_bench``:

- Levenberg-Marquardt (``pgo.optimize`` with ``algorithm="lm"``): poses
  within 1e-4, chi within 1e-4 relative, the same iteration count;
- ``solve_spd_scaled_batched``: within 1e-5 relative, the finite guard;
- matrix-free PCG (``solver/cg.py``): poses within 1e-4 and the same GN
  iteration count; the sorted-segment-sum order and the chunked
  linearization within 1e-5 of the plain path;
- the analytic edge Jacobians against ``jax.jacfwd``;
- Schur (``solver/schur.py``): ``partition_graph``'s arrays EQUAL, poses
  within 1e-3, the P % 256 rule of the chunked elimination;
- the generators: the same graph from the same seed, ``edge_chi`` within
  1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.bench import pgo_bench as jbench
from srrg2_laser_slam_2d_tpu.solver import cg as jcg
from srrg2_laser_slam_2d_tpu.solver import pgo as jpgo
from srrg2_laser_slam_2d_tpu.solver import schur as jschur
from srrg2_laser_slam_2d_tpu_torch.bench import pgo_bench as tbench
from srrg2_laser_slam_2d_tpu_torch.solver import cg as tcg
from srrg2_laser_slam_2d_tpu_torch.solver import pgo as tpgo
from srrg2_laser_slam_2d_tpu_torch.solver import schur as tschur
from tests.test_cg import grid_graph
from tests.test_pgo import build_circle_graph


def port_graph(g) -> tpgo.PoseGraph:
    """The port's PoseGraph for a JAX one (same values, on the CPU)."""
    return tpgo.graph_from_numpy(*[np.array(x) for x in g], device="cpu")


def _hold(jout, tout, tol):
    jg, jchi, jit = jout
    tg, tchi, tit = tout
    np.testing.assert_allclose(tg.poses.numpy(), np.asarray(jg.poses), atol=tol)
    assert float(tchi) == pytest.approx(float(jchi), rel=1e-4, abs=1e-7)
    assert tit == int(jit)


@pytest.mark.parametrize("circle,iterations", [(dict(), 40), (dict(noise=0.15, seed=3), 30)],
                         ids=["matches_gn", "never_increases_chi"])
def test_lm_matches_jax(circle, iterations):
    graph, _, _, n = build_circle_graph(**circle)
    kw = dict(max_iterations=iterations, algorithm="lm")
    jout = jpgo.optimize(jpgo.PGOConfig(**kw), graph)
    tout = tpgo.optimize(tpgo.PGOConfig(**kw), port_graph(graph))
    _hold(jout, tout, 1e-4)
    # the accept / reject loop never raises chi above the initial one
    assert float(tout[1]) <= float(tpgo.graph_chi(port_graph(graph))) + 1e-5
    assert tout[2] > 1


def test_solve_spd_scaled_batched_matches_jax():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(5, 12, 12)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) + np.diag(rng.uniform(1e-3, 1e3, 12)).astype(np.float32)
    B = rng.normal(size=(5, 12, 4)).astype(np.float32)
    H[3] = np.nan       # a system beyond float32: its step is zeroed
    want = np.asarray(jpgo.solve_spd_scaled_batched(jnp.asarray(H), jnp.asarray(B)))
    got = tpgo.solve_spd_scaled_batched(torch.from_numpy(H), torch.from_numpy(B)).numpy()
    assert not got[3].any() and not want[3].any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_edge_jacobians_match_jacfwd():
    rng = np.random.default_rng(1)
    xi, xj, meas = (rng.uniform(-3, 3, (64, 3)).astype(np.float32) for _ in range(3))
    jJi, jJj = jpgo._edge_jac(jnp.zeros(3), jnp.zeros(3), *map(jnp.asarray, (xi, xj, meas)))
    tJi, tJj = tpgo.edge_jacobians(*map(torch.from_numpy, (xi, xj, meas)))
    np.testing.assert_allclose(tJi.numpy(), np.asarray(jJi), atol=1e-5)
    np.testing.assert_allclose(tJj.numpy(), np.asarray(jJj), atol=1e-5)


def test_cg_matches_jax_on_circle():
    graph, _, _, n = build_circle_graph()
    cfg = dict(gn_iterations=10, cg_iterations=100, cg_tolerance=1e-9)
    _hold(jcg.optimize_cg(jcg.CGConfig(**cfg), graph),
          tcg.optimize_cg(tcg.CGConfig(**cfg), port_graph(graph)), 1e-4)


def test_cg_matches_jax_on_grid_graph():
    graph, _, v = grid_graph(side=16)
    cfg = dict(gn_iterations=8, cg_iterations=100)
    tout = tcg.optimize_cg(tcg.CGConfig(**cfg), port_graph(graph))
    _hold(jcg.optimize_cg(jcg.CGConfig(**cfg), graph), tout, 1e-4)
    chi0 = float(tpgo.graph_chi(port_graph(graph)))
    assert float(tpgo.graph_chi(tout[0])) < 0.05 * chi0


def test_sorted_order_and_chunked_linearization_match_baseline():
    """The million-node controls (sorted segment sums through ``EdgeOrder``
    and ``jac_chunk``) give the plain path's result, and JAX's."""
    jgraph = jbench.make_grid_graph(8)              # 64 nodes, edge capacity 128
    graph = port_graph(jgraph)
    ref, chi_ref, it_ref = tcg.optimize_cg(tcg.CGConfig(gn_iterations=4, cg_iterations=30),
                                           graph)
    order = tcg.prepare_edge_order(graph)
    jorder = jcg.prepare_edge_order(jgraph)
    np.testing.assert_array_equal(order.perm.numpy(), np.asarray(jorder.perm))
    np.testing.assert_array_equal(order.rows.numpy(), np.asarray(jorder.rows))
    cfg1 = dict(gn_iterations=4, cg_iterations=30, jac_chunk=32)
    out, chi, it = tcg.optimize_cg(tcg.CGConfig(**cfg1), graph, order)
    np.testing.assert_allclose(out.poses.numpy(), ref.poses.numpy(), atol=1e-5)
    assert float(chi) == pytest.approx(float(chi_ref), rel=1e-5)
    assert it == it_ref
    _hold(jcg.optimize_cg(jcg.CGConfig(**cfg1), jgraph, jorder), (out, chi, it), 1e-4)


def test_edge_order_refuses_a_hub():
    """The sorted sums' [V, L] slot table is sized by the busiest variable:
    a graph whose every edge touches variable 0 is refused, and solves
    without an order."""
    v, e = 1024, 4096
    rng = np.random.default_rng(2)
    hub = tpgo.graph_from_numpy(
        rng.normal(size=(v, 3)), np.ones(v, bool), np.arange(v) == 0, np.zeros(e, np.int64),
        rng.integers(1, v, e), rng.normal(size=(e, 3)), np.ones((e, 3)), np.ones(e, bool),
        device="cpu")
    with pytest.raises(ValueError, match="order=None"):
        tcg.prepare_edge_order(hub)
    _, chi, _ = tcg.optimize_cg(tcg.CGConfig(gn_iterations=2, cg_iterations=10), hub)
    assert np.isfinite(float(chi))


def test_linearize_blocks_chunked_equals_one_shot():
    graph = port_graph(jbench.make_grid_graph(8))
    one = tcg._linearize_blocks(graph, 0.5, 0)
    chunked = tcg._linearize_blocks(graph, 0.5, 32)
    for a, b in zip(one, chunked):
        assert torch.equal(a, b)


def _partitions_equal(jg, n_parts, n_vars=None):
    jp = jschur.partition_graph(jg, n_parts, n_vars=n_vars)
    tp = tschur.partition_graph(port_graph(jg), n_parts, n_vars=n_vars)
    for name, a, b in zip(jp._fields, jp, tp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    return jp, tp


@pytest.mark.parametrize("which", ["circle", "grid16", "chain2048_p512"])
def test_partition_graph_matches_jax(which):
    if which == "circle":
        g, _, _, n = build_circle_graph()
        _partitions_equal(g, 4, n)
    elif which == "grid16":
        g, _, v = grid_graph(side=16)
        _, tp = _partitions_equal(g, 4, v)
        # every valid variable once, interior xor separator; a small separator
        interior, sep = tp.interior_idx.numpy(), tp.separator_idx.numpy()
        cap = g.var_capacity
        seen = list(interior[interior < cap]) + list(sep[sep < cap])
        assert len(seen) == len(set(seen)) and set(seen) == set(range(v))
        assert (sep < cap).sum() < v * 0.6
    else:
        _partitions_equal(jbench.make_chain_graph(2048), 512)


def test_schur_matches_jax_on_circle():
    graph, _, _, n = build_circle_graph()
    cfg = dict(max_iterations=10)
    jout = jschur.optimize_schur(jpgo.PGOConfig(**cfg), graph,
                                 jschur.partition_graph(graph, 4, n_vars=n))
    tg = port_graph(graph)
    tout = tschur.optimize_schur(tpgo.PGOConfig(**cfg), tg, tschur.partition_graph(tg, 4, n_vars=n))
    np.testing.assert_allclose(tout[0].poses.numpy(), np.asarray(jout[0].poses), atol=1e-3)
    assert tout[2] == int(jout[2])


def test_schur_matches_jax_on_grid():
    graph, _, v = grid_graph(side=12)
    cfg = dict(max_iterations=6)
    jout = jschur.optimize_schur(jpgo.PGOConfig(**cfg), graph,
                                 jschur.partition_graph(graph, 4, n_vars=v))
    tg = port_graph(graph)
    tout = tschur.optimize_schur(tpgo.PGOConfig(**cfg), tg, tschur.partition_graph(tg, 4, n_vars=v))
    np.testing.assert_allclose(tout[0].poses.numpy(), np.asarray(jout[0].poses), atol=1e-3)
    assert float(tout[1]) == pytest.approx(float(jout[1]), rel=1e-3)


def test_schur_chunked_elimination_matches_jax():
    """P = 512 partitions: the interior solves run in two chunks of 256."""
    jg = jbench.make_chain_graph(2048)
    cfg = dict(max_iterations=3)
    jout = jschur.optimize_schur(jpgo.PGOConfig(**cfg), jg, jschur.partition_graph(jg, 512))
    tg = port_graph(jg)
    tout = tschur.optimize_schur(tpgo.PGOConfig(**cfg), tg, tschur.partition_graph(tg, 512))
    np.testing.assert_allclose(tout[0].poses.numpy(), np.asarray(jout[0].poses), atol=1e-3)
    assert torch.isfinite(tout[0].poses).all() and tout[2] == int(jout[2])


def test_schur_refuses_partition_counts_off_the_chunk_rule():
    tg = tbench.make_chain_graph(2048)
    with pytest.raises(ValueError, match="% 256 == 0"):
        tschur.optimize_schur(tpgo.PGOConfig(max_iterations=1), tg,
                              tschur.partition_graph(tg, 650))
    assert tschur.elimination_chunks(511) == 1 and tschur.elimination_chunks(1024) == 4


@pytest.mark.parametrize("which", ["grid8", "chain512"])
def test_generators_match_jax(which):
    jg, tg = ((jbench.make_grid_graph(8), tbench.make_grid_graph(8)) if which == "grid8"
              else (jbench.make_chain_graph(512), tbench.make_chain_graph(512)))
    for name, a, b in zip(jg._fields, jg, tg):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert tbench.edge_chi(tg) == pytest.approx(jbench.edge_chi(jg), rel=1e-5)
    assert tbench.edge_chi(tg, chunk=16) == pytest.approx(tbench.edge_chi(tg), rel=1e-5)


def test_chain_graphs_never_nan():
    """tests/test_pgo.py::test_chain_graphs_never_nan on the port: the scaled
    solve and the divergence guard keep long anchored chains finite, and LM
    and PCG converge on them."""
    for n in (64, 256):
        g = tbench.make_chain_graph(n)
        out, _, _ = tpgo.optimize(tpgo.PGOConfig(max_iterations=10), g)
        assert bool(torch.isfinite(out.poses).all()), n
        lm, _, _ = tpgo.optimize(tpgo.PGOConfig(max_iterations=20, algorithm="lm"), g)
        assert bool(torch.isfinite(lm.poses).all()), n
        assert tbench.edge_chi(lm) < tbench.edge_chi(g), n
        sc, _, _ = tcg.optimize_cg(tcg.CGConfig(gn_iterations=10, cg_iterations=100), g)
        assert tbench.edge_chi(sc) < 0.05 * tbench.edge_chi(g), (n, tbench.edge_chi(sc))


def test_pgo_bench_runs_on_the_host():
    r = tbench.run(8, gn_iterations=3, cg_iterations=30, reps=1, device="cpu")
    assert r.nodes == 64 and r.edges == 112 and r.iterations == 3
    assert r.chi1 < 0.05 * r.chi0 and r.chi_per_iteration[0] == pytest.approx(r.chi0, rel=1e-5)
    assert len(r.cg_iterations) == 3 and r.device == "cpu" and r.peak_device_bytes is None
