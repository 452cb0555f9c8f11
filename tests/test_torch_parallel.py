"""The port's parallel layer on ``torch.distributed`` (gloo, 2 and 4 CPU
ranks started by ``parallel/multihost.spawn_ranks``) against the JAX
package's goldens on the same numpy inputs (``tests/test_parallel.py``,
``tests/test_schur.py``, ``__graft_entry__.dryrun_multichip``):

- ``dist_pgo.optimize_sharded`` on ``test_pgo.build_circle_graph``: every
  rank's poses EQUAL (every rank solves the same reduced system), poses to
  1e-4 and chi to rtol 1e-3 against the JAX ``pgo.optimize``;
- ``batch_align_sharded`` on the 8-candidate spiral: EQUAL to the port's
  batched aligner in one process (the same per-candidate arithmetic), within
  1e-5 of the JAX ``vmap`` of ``icp.align`` and, as there, a median error
  below 1e-4 and a second-worst below 5e-3;
- ``schur.optimize_schur_sharded`` on the 12 x 12 grid at 8 partitions:
  poses to 1e-3 and chi within 1 % of the JAX ``optimize_schur``;
- ``HostShardedSceneStore.get``: the owner's scene on every rank;
- ``dryrun_multichip(n)``: the JAX summary line's values (PGO chi and
  iterations, Schur chi, the aligned batch) from the JAX parallel layer on
  the JAX package's ring.

Top-level imports are the port's only: the spawned ranks import this module
to find ``_pieces`` (the JAX package is imported inside the tests)."""

import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

from srrg2_laser_slam_2d_tpu_torch.models.loop_closure import _batch_align_pairs
from srrg2_laser_slam_2d_tpu_torch.ops import icp as ticp
from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection
from srrg2_laser_slam_2d_tpu_torch.parallel import dryrun, mesh, multihost
from srrg2_laser_slam_2d_tpu_torch.parallel.batch_align import batch_align_sharded
from srrg2_laser_slam_2d_tpu_torch.parallel.dist_pgo import optimize_sharded, shard_edges
from srrg2_laser_slam_2d_tpu_torch.solver import pgo as tpgo
from srrg2_laser_slam_2d_tpu_torch.solver import schur as tschur
from srrg2_laser_slam_2d_tpu_torch.utils import cloud as tcloud

K_ALIGN = 8
SCHUR_PARTS = 8
GRAPH_FIELDS = ("poses", "var_valid", "var_fixed", "edge_i", "edge_j", "edge_meas",
                "edge_info", "edge_valid")


def _spiral(device="cpu"):
    """``tests/test_parallel.py``'s spiral batch: K copies of a 128-point
    spiral (off the canvas's bin edges), initial offsets N(0, 0.008)."""
    rng = np.random.default_rng(2)
    n_pts = 128
    angles = (np.arange(n_pts) + 0.27) * (2 * np.pi / n_pts) - np.pi
    radii = 2.0 + 0.25 * angles
    xy = np.stack([radii * np.cos(angles), radii * np.sin(angles)], 1).astype(np.float32)
    nrm = (-xy / np.linalg.norm(xy, axis=1, keepdims=True)).astype(np.float32)
    initials = rng.normal(scale=0.008, size=(K_ALIGN, 3)).astype(np.float32)
    return xy, nrm, initials


ALIGN_PROJ = dict(cols=128, angle_min=-np.pi, angle_max=np.pi, range_min=0.1, range_max=10.0)


def _pieces(device, graphs) -> dict:
    """Every rank's part: the sharded PGO, batch alignment and Schur solve,
    the scene store, the mesh helpers."""
    world, rank = dist.get_world_size(), dist.get_rank()
    circle = tpgo.graph_from_numpy(*graphs["circle"], device=device)
    out, chi, it = optimize_sharded(tpgo.PGOConfig(max_iterations=10), shard_edges(circle), None)

    xy, nrm, initials = _spiral()
    base = tcloud.from_numpy(xy, nrm, device=device)
    batch = base.map(lambda x: torch.stack([x] * K_ALIGN))
    res = batch_align_sharded(ticp.AlignerConfig(max_iterations=8),
                              PolarProjection.make(**ALIGN_PROJ), None, batch, batch,
                              torch.from_numpy(initials))

    grid = tpgo.graph_from_numpy(*graphs["grid"], device=device)
    part = tschur.partition_graph(grid, n_parts=SCHUR_PARTS, n_vars=graphs["grid_v"])
    sout, schi, _ = tschur.optimize_schur_sharded(tpgo.PGOConfig(max_iterations=5), grid, part)
    try:
        tschur.optimize_schur_sharded(tpgo.PGOConfig(), grid,
                                      tschur.partition_graph(grid, n_parts=3, n_vars=16))
        refused = False
    except ValueError as e:
        refused = "not divisible" in str(e)

    store = multihost.HostShardedSceneStore(rank, world, device)
    for m in range(4):
        store.put(m, (np.full((8, 2), float(m), np.float32), np.arange(8) % (m + 2) == 0))
    template = (np.zeros((8, 2), np.float32), np.zeros(8, bool))
    fetched = [store.get(m, template) for m in range(4)]

    sub = mesh.make_group(1)
    return {"rank": rank, "world": world, "backend": dist.get_backend(),
            "pgo_poses": out.poses.numpy(), "pgo_chi": float(chi), "pgo_iters": it,
            "align_estimate": res.estimate.numpy(), "align_inliers": res.num_inliers.numpy(),
            "schur_poses": sout.poses.numpy(), "schur_chi": float(schi),
            "refused_3_parts": refused,
            "local_ids": store.local_ids(), "fetched": fetched,
            "rank_slice": mesh.rank_slice(K_ALIGN),
            "sub_world": dist.get_world_size(sub) if rank == 0 else None}


def _graph_arrays(graph):
    return tuple(np.asarray(getattr(graph, f)) for f in GRAPH_FIELDS)


@pytest.fixture(scope="module")
def goldens():
    """The inputs as numpy arrays and the JAX package's single-device results."""
    import jax
    import jax.numpy as jnp
    from srrg2_laser_slam_2d_tpu.ops import icp as jicp
    from srrg2_laser_slam_2d_tpu.ops.projector import PolarProjection as JProjection
    from srrg2_laser_slam_2d_tpu.solver import pgo as jpgo
    from srrg2_laser_slam_2d_tpu.solver import schur as jschur
    from srrg2_laser_slam_2d_tpu.utils import cloud as jcloud

    from test_cg import grid_graph
    from test_pgo import build_circle_graph

    circle, _, _, n = build_circle_graph()
    ref, chi_ref, _ = jpgo.optimize(jpgo.PGOConfig(max_iterations=10), circle)
    grid, _, v = grid_graph(side=12)
    jpart = jschur.partition_graph(grid, n_parts=SCHUR_PARTS, n_vars=v)
    sref, schi_ref, _ = jschur.optimize_schur(jpgo.PGOConfig(max_iterations=5), grid, jpart)
    xy, nrm, initials = _spiral()
    jb = jax.tree.map(lambda x: jnp.stack([x] * K_ALIGN), jcloud.from_numpy(xy, nrm))
    acfg, proj = jicp.AlignerConfig(max_iterations=8), JProjection.make(**ALIGN_PROJ)
    vm = jax.vmap(lambda f, m, i: jicp.align(acfg, proj, f, m, i))(jb, jb, jnp.asarray(initials))
    return {"graphs": {"circle": _graph_arrays(circle), "grid": _graph_arrays(grid), "grid_v": v},
            "n": n, "v": v, "pgo_poses": np.asarray(ref.poses[:n]), "pgo_chi": float(chi_ref),
            "schur_poses": np.asarray(sref.poses[:v]), "schur_chi": float(schi_ref),
            "align_estimate": np.asarray(vm.estimate)}


@pytest.fixture(scope="module", params=[2, 4], ids=["gloo2", "gloo4"])
def ranks(request, goldens):
    return multihost.spawn_ranks(request.param, _pieces, goldens["graphs"], device="cpu")


def test_ranks_form_one_gloo_group(ranks):
    n = len(ranks)
    assert [r["rank"] for r in ranks] == list(range(n))
    assert all(r["world"] == n and r["backend"] == "gloo" for r in ranks)
    per = K_ALIGN // n
    assert [r["rank_slice"] for r in ranks] == [slice(k * per, (k + 1) * per) for k in range(n)]
    assert ranks[0]["sub_world"] == 1


def test_optimize_sharded_matches_jax(ranks, goldens):
    n = goldens["n"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["pgo_poses"], ranks[0]["pgo_poses"])
        assert r["pgo_chi"] == ranks[0]["pgo_chi"]
    np.testing.assert_allclose(ranks[0]["pgo_poses"][:n], goldens["pgo_poses"], atol=1e-4)
    np.testing.assert_allclose(ranks[0]["pgo_chi"], goldens["pgo_chi"], rtol=1e-3, atol=1e-5)
    # and the port's single-process solver
    single, chi, _ = tpgo.optimize(tpgo.PGOConfig(max_iterations=10),
                                   tpgo.graph_from_numpy(*goldens["graphs"]["circle"]))
    np.testing.assert_allclose(ranks[0]["pgo_poses"], single.poses.numpy(), atol=1e-5)


def test_batch_align_sharded_matches_jax(ranks, goldens):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["align_estimate"], ranks[0]["align_estimate"])
    est = ranks[0]["align_estimate"]
    assert est.shape == (K_ALIGN, 3)
    xy, nrm, initials = _spiral()
    batch = tcloud.from_numpy(xy, nrm).map(lambda x: torch.stack([x] * K_ALIGN))
    single = _batch_align_pairs(ticp.AlignerConfig(max_iterations=8),
                                PolarProjection.make(**ALIGN_PROJ), batch, batch,
                                torch.from_numpy(initials))
    np.testing.assert_array_equal(est, single.estimate.numpy())
    np.testing.assert_array_equal(ranks[0]["align_inliers"], single.num_inliers.numpy())
    np.testing.assert_allclose(est, goldens["align_estimate"], atol=1e-5)
    errs = np.max(np.abs(est), axis=1)
    assert np.median(errs) < 1e-4, errs
    assert np.sort(errs)[-2] < 5e-3, errs


def test_schur_sharded_matches_jax(ranks, goldens):
    v = goldens["v"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["schur_poses"], ranks[0]["schur_poses"])
    np.testing.assert_allclose(ranks[0]["schur_poses"][:v], goldens["schur_poses"], atol=1e-3)
    assert abs(ranks[0]["schur_chi"] - goldens["schur_chi"]) < 1e-2 * max(goldens["schur_chi"],
                                                                          1.0)


def test_schur_sharded_refuses_parts_not_divisible_by_the_ranks(ranks):
    assert all(r["refused_3_parts"] for r in ranks)


def test_scene_store_get_returns_the_owners_scene(ranks):
    n = len(ranks)
    for r in ranks:
        assert r["local_ids"] == [m for m in range(4) if m % n == r["rank"]]
        for m, (xy, valid) in enumerate(r["fetched"]):
            np.testing.assert_array_equal(xy, np.full((8, 2), float(m), np.float32))
            np.testing.assert_array_equal(valid, np.arange(8) % (m + 2) == 0)
            assert valid.dtype == bool


def _jax_dryrun_values(n: int) -> dict:
    """The PGO, Schur and alignment values of the JAX
    ``dryrun_multichip(n)`` on its own ring, through the JAX parallel layer
    (its K-stream part runs the Pallas kernel in interpret mode for minutes
    and is left out)."""
    import jax
    import jax.numpy as jnp
    from srrg2_laser_slam_2d_tpu.ops import icp as jicp
    from srrg2_laser_slam_2d_tpu.ops.projector import PolarProjection as JProjection
    from srrg2_laser_slam_2d_tpu.parallel import dist_pgo as jdist
    from srrg2_laser_slam_2d_tpu.parallel.mesh import make_mesh
    from srrg2_laser_slam_2d_tpu.solver import pgo as jpgo
    from srrg2_laser_slam_2d_tpu.solver import schur as jschur
    from srrg2_laser_slam_2d_tpu.utils import cloud as jcloud
    from srrg2_laser_slam_2d_tpu.utils import geometry as jgeo

    mesh_ = make_mesh(n)
    v, ec = 16, max(n * 4, 32)
    rng = np.random.default_rng(0)
    poses, p = [], np.zeros(3, np.float32)
    step = np.array([1.0, 0.0, 2 * np.pi / v], np.float32)
    for _ in range(v):
        poses.append(p)
        p = np.asarray(jgeo.compose(jnp.asarray(p), jnp.asarray(step)))
    poses = np.stack(poses) + rng.normal(scale=0.05, size=(v, 3)).astype(np.float32)
    meas = np.stack([np.asarray(jgeo.relative(jnp.asarray(poses[k]),
                                              jnp.asarray(poses[(k + 1) % v])))
                     for k in range(v)])
    g = jpgo.empty_graph(var_capacity=v, edge_capacity=ec)
    g = g._replace(
        poses=g.poses.at[:v].set(jnp.asarray(poses)), var_valid=g.var_valid.at[:v].set(True),
        var_fixed=g.var_fixed.at[0].set(True),
        edge_i=g.edge_i.at[:v].set(jnp.arange(v, dtype=jnp.int32)),
        edge_j=g.edge_j.at[:v].set(jnp.asarray([(k + 1) % v for k in range(v)], jnp.int32)),
        edge_meas=g.edge_meas.at[:v].set(jnp.asarray(meas)),
        edge_valid=g.edge_valid.at[:v].set(True))
    _, chi, iters = jdist.optimize_sharded(jpgo.PGOConfig(max_iterations=3),
                                           jdist.shard_edges(g, mesh_), mesh_)
    part = jschur.partition_graph(g, n_parts=n, n_vars=v)
    _, schi, _ = jschur.optimize_schur_sharded(jpgo.PGOConfig(max_iterations=2), g, part, mesh_)
    n_pts = 128
    angles = (np.arange(n_pts) + 0.27) * (2 * np.pi / n_pts) - np.pi
    xy = np.stack([2.0 * np.cos(angles), 2.0 * np.sin(angles)], 1).astype(np.float32)
    nrm = (-xy / np.linalg.norm(xy, axis=1, keepdims=True)).astype(np.float32)
    jb = jax.tree.map(lambda x: jnp.stack([x] * (2 * n)), jcloud.from_numpy(xy, nrm))
    initials = jnp.asarray(rng.normal(scale=0.05, size=(2 * n, 3)).astype(np.float32))
    acfg, proj = jicp.AlignerConfig(max_iterations=5), JProjection.make(**ALIGN_PROJ)
    res = jax.vmap(lambda f, m, i: jicp.align(acfg, proj, f, m, i))(jb, jb, initials)
    return {"graph": g, "pgo_chi": float(chi), "pgo_iters": int(iters),
            "schur_chi": float(schi),
            "batch_align_max_abs_est": float(jnp.max(jnp.abs(res.estimate)))}


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_matches_the_jax_summary(n, capsys):
    out = dryrun.dryrun_multichip(n, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == dryrun.summary_line(out)
    assert re.fullmatch(
        rf"dryrun_multichip\({n}\): pgo chi=[0-9.]+ iters=\d+; schur chi=[0-9.]+; "
        r"batch_align max \|est\|=[0-9.]+; stream poses max \|x\|=[0-9.]+", line)
    assert out["n"] == n and out["backend"] == "gloo"
    jax_vals = _jax_dryrun_values(n)
    # the same ring in both packages
    ring = dryrun.ring_graph(16, max(n * 4, 32), np.random.default_rng(0), "cpu")
    for f in GRAPH_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(ring, f), np.float64),
                                   np.asarray(getattr(jax_vals["graph"], f), np.float64),
                                   atol=1e-6)
    assert out["pgo_iters"] == jax_vals["pgo_iters"]
    for key in ("pgo_chi", "schur_chi", "batch_align_max_abs_est"):
        np.testing.assert_allclose(out[key], jax_vals[key], rtol=1e-3, atol=1e-5)
    assert 0 < out["stream_max_abs_pose"] < 1.0
