"""The SLAM loops' global solve routed through the large-graph solvers
(``global_solver_kind`` "cg" and "schur"), the port against the JAX
package on the CPU, both reading one configuration file:

- the per-message ``GraphSLAM2D`` on tests/test_slam.py's circle drive
  (test_loop_closure_with_alternative_global_solvers: 40 steps, 512 beams,
  seed 5): variables, factors and closures EQUAL, final poses within
  2.5e-2 m, the on-grid drift that ROADMAP.md Queue 3 documents for this
  drive on the dense solver (every solve reaches the chosen solver);
- the port's solve (``GraphSLAM2D._solve_graph``) fed each graph the JAX
  run solved, exported to numpy: within 1e-4 of the JAX solution (CG) or
  1e-3 (Schur);
- the chunked loop on tests/test_torch_chunked_slam.py's drive, with the
  relocalizer on and, for the deferred pose fetch, off: the counters of
  that file's ``_hold_graphs`` and trajectories within its 1e-2.
"""

import dataclasses

import numpy as np
import pytest

from srrg2_laser_slam_2d_tpu.bench import synthetic
from srrg2_laser_slam_2d_tpu.solver import pgo as jpgo
from srrg2_laser_slam_2d_tpu_torch.models import chunked_slam as tcs
from srrg2_laser_slam_2d_tpu_torch.models import slam as tslam_mod
from srrg2_laser_slam_2d_tpu_torch.solver import cg as tcg
from srrg2_laser_slam_2d_tpu_torch.solver import schur as tschur
from tests.test_slam import make_pipeline
from tests.test_torch_chunked_slam import _drive, _hold_graphs, _hold_trajectories, _run_both
from tests.test_torch_slam import _port_config, _port_preprocessor

SOLVERS = {"cg": (tcg, "optimize_cg", 1e-4), "schur": (tschur, "optimize_schur", 1e-3)}


class _Calls:
    """Counts the calls that reach a port solver."""

    def __init__(self, mp, kind):
        mod, name, _ = SOLVERS[kind]
        self.n, fn = 0, getattr(mod, name)

        def counted(*a, **kw):
            self.n += 1
            return fn(*a, **kw)

        mp.setattr(mod, name, counted)


@pytest.fixture(scope="module", params=list(SOLVERS))
def per_message(request, tmp_path_factory):
    """Both per-message loops over the circle drive under one solver kind;
    each graph the JAX loop solved and its solution recorded."""
    kind = request.param
    ds = synthetic.simulate(synthetic.SyntheticConfig(
        steps=40, num_beams=512, max_variance=0.02, drift=(0.15, 0.0, 2 * np.pi / 40),
        seed=5))
    jslam, jpre = make_pipeline(ds, local_map_distance=0.5, enable_loops=True)
    jslam.cfg = dataclasses.replace(jslam.cfg, global_solver_kind=kind)
    tcfg = _port_config(jslam.cfg, tmp_path_factory.mktemp("cfg") / "slam.json")
    assert tcfg.global_solver_kind == kind
    solves = []
    solve = jslam._global_solve

    def recorded():
        nv, ne = jslam.n_maps, jslam.n_edges
        graph = jpgo.PoseGraph(*(np.array(x) for x in jslam.graph))
        solve()
        solves.append((graph, nv, ne, np.array(jslam.graph.poses)[:nv]))

    jslam._global_solve = recorded
    tslam = tslam_mod.GraphSLAM2D(tcfg, sensor_in_robot=np.array(ds.config.sensor_in_robot,
                                                                  np.float32), device="cpu")
    tp = _port_preprocessor(ds.config)
    with pytest.MonkeyPatch.context() as mp:
        calls = _Calls(mp, kind)
        for k in range(len(ds.ranges)):
            jslam.process(jpre.compute(ds.ranges[k]), ds.robot_poses[k])
            tslam.process(tp.compute(ds.ranges[k]), ds.robot_poses[k])
            assert (tslam.num_variables(), tslam.num_factors(), tslam.num_closures) == \
                (jslam.num_variables(), jslam.num_factors(), jslam.num_closures), k
    return kind, ds, jslam, tslam, calls.n, solves, tcfg


def test_per_message_loop_matches_jax(per_message):
    kind, ds, jslam, tslam, n_calls, solves, _ = per_message
    assert tslam.num_closures >= 1 and n_calls >= 1 and len(solves) >= 1
    np.testing.assert_allclose(tslam.poses_np, np.asarray(jslam.poses_np)[: jslam.n_maps],
                               atol=2.5e-2)
    np.testing.assert_allclose(tslam.robot_in_world(), np.asarray(jslam.robot_in_world()),
                               atol=2.5e-2)
    # the JAX test's bound against the ground truth holds for the port too
    err = np.abs(tslam.robot_in_world() - ds.robot_poses[-1])
    assert np.linalg.norm(err[:2]) < 0.25, (kind, err)


def test_port_solver_on_the_jax_runs_graphs(per_message):
    kind, _, _, _, _, solves, tcfg = per_message
    tol = SOLVERS[kind][2]
    for graph, nv, ne, want in solves:
        slam = tslam_mod.GraphSLAM2D(tcfg, device="cpu")
        slam._poses_host = graph.poses[:nv].copy()
        slam._fixed_host = [bool(f) for f in graph.var_fixed[:nv]]
        slam._edges_host = [(int(graph.edge_i[k]), int(graph.edge_j[k]), graph.edge_meas[k],
                             graph.edge_info[k]) for k in range(ne)]
        slam.n_maps, slam.n_edges = nv, ne
        got = slam._solve_graph().poses[:nv].numpy()
        np.testing.assert_allclose(got, want, atol=tol, err_msg=f"{kind}, {nv} variables")


@pytest.mark.parametrize("relocalizer", [True, False], ids=["relocalizer", "deferred_fetch"])
@pytest.mark.parametrize("kind", list(SOLVERS))
def test_chunked_loop_matches_jax(kind, relocalizer, tmp_path_factory):
    ds, pre, jcfg, tcfg = _drive(tmp_path_factory, backend="fused_nn", fused_corr_refresh=3)
    jcfg = dataclasses.replace(jcfg, global_solver_kind=kind, enable_relocalizer=relocalizer)
    tcfg = dataclasses.replace(tcfg, global_solver_kind=kind, enable_relocalizer=relocalizer)
    deferred = []
    fetch = tcs.ChunkedGraphSLAM2D._fetch_poses

    def counted_fetch(slam):
        deferred.append(slam._pending_poses is not None)
        fetch(slam)

    with pytest.MonkeyPatch.context() as mp:
        calls = _Calls(mp, kind)
        mp.setattr(tcs.ChunkedGraphSLAM2D, "_fetch_poses", counted_fetch)
        jslam, tslam = _run_both((ds, pre, jcfg, tcfg))
        _hold_graphs(jslam, tslam)
        _hold_trajectories(jslam, tslam)
    assert calls.n >= 1
    # with the relocalizer off the solved poses wait for the next read
    assert any(deferred) != relocalizer
    assert tslam._pending_poses is None
