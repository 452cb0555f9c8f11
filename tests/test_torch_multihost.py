"""``parallel/multihost.py`` and ``parallel/scaling.py`` of the port on the
CPU: N worker processes (``python -m
srrg2_laser_slam_2d_tpu_torch.parallel.multihost --worker``) in one gloo
group with a ``file://`` rendezvous, each holding only its block of the
ring's edges, against the JAX golden ``tests/test_multiprocess.py`` (equal
poses to 1e-5 across ranks, and 1e-3 against the single-process solve of
the JAX package on the same arrays); the scene store fetching a remote map;
the scaling harness at 2 ranks; and the backend rule (gloo for the CPU,
never NCCL there)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from srrg2_laser_slam_2d_tpu_torch.parallel import multihost, scaling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_build_ring_matches_the_jax_worker():
    from multiprocess_worker import build_ring as jax_ring

    for t, j in zip(multihost.build_ring(), jax_ring(), strict=True):
        np.testing.assert_allclose(np.asarray(t, np.float64), np.asarray(j, np.float64),
                                   atol=1e-5)


@pytest.mark.parametrize("nproc", [2, 4])
def test_multiprocess_pgo_matches_single_process(tmp_path, nproc):
    import jax.numpy as jnp
    from srrg2_laser_slam_2d_tpu.solver import pgo as jpgo

    init = "file://" + str(tmp_path / "rendezvous")
    outs = [str(tmp_path / f"w{p}.npz") for p in range(nproc)]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "srrg2_laser_slam_2d_tpu_torch.parallel.multihost", "--worker",
         str(p), str(nproc), init, outs[p], "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        for p in range(nproc)]
    logs = [pr.communicate(timeout=300)[0].decode() for pr in procs]
    for p, pr in enumerate(procs):
        assert pr.returncode == 0, f"worker {p} failed:\n{logs[p][-3000:]}"

    ws = [np.load(o) for o in outs]
    w0 = ws[0]
    assert int(w0["world_size"]) == nproc and str(w0["backend"]) == "gloo"
    for w in ws[1:]:
        np.testing.assert_allclose(w["poses"], w0["poses"], atol=1e-5)

    # the JAX package's single-process solve on the worker's own arrays
    est, ei, ej, meas = w0["est"], w0["ei"], w0["ej"], w0["meas"]
    v = len(est)
    g = jpgo.empty_graph(32, 32)
    g = g._replace(
        poses=g.poses.at[:v].set(jnp.asarray(est)), var_valid=g.var_valid.at[:v].set(True),
        var_fixed=g.var_fixed.at[0].set(True),
        edge_i=g.edge_i.at[:len(ei)].set(jnp.asarray(ei, jnp.int32)),
        edge_j=g.edge_j.at[:len(ej)].set(jnp.asarray(ej, jnp.int32)),
        edge_meas=g.edge_meas.at[:len(meas)].set(jnp.asarray(meas)),
        edge_valid=g.edge_valid.at[:len(ei)].set(True))
    ref, _, _ = jpgo.optimize(jpgo.PGOConfig(max_iterations=10), g)
    np.testing.assert_allclose(w0["poses"], np.asarray(ref.poses[:v]), atol=1e-3)

    # the host-sharded scene store: map 1 fetched on every worker (remote
    # for all but its owner)
    for w in ws:
        np.testing.assert_allclose(w["fetched"], np.full((8, 2), float(w["remote_id"])))
        assert w["fetched_valid"].all()


def test_scaling_harness_at_two_ranks(capsys):
    out = scaling.main(["--what", "all", "--side", "8", "--world", "2", "--device", "cpu"])
    assert out["world_size"] == 2 and out["backend"] == "gloo"
    assert "not device numbers" in out["note"]
    for name in ("pgo", "align", "schur", "streams"):
        rows = out[name]
        assert [r["devices"] for r in rows] == [1, 2], name
        assert rows[0]["speedup"] == 1.0 and all(r["seconds"] > 0 for r in rows)
    assert [r["candidates"] for r in out["align"]] == [4, 8]
    assert [r["streams"] for r in out["streams"]] == [4, 8]
    assert out["streams"][0]["chained_calls"] == 5
    # the same chi at every group size (the same graph, the sums reordered)
    for name in ("pgo", "schur"):
        np.testing.assert_allclose(out[name][1]["chi"], out[name][0]["chi"], rtol=1e-4)
    printed = capsys.readouterr().out.splitlines()
    assert printed[-1].startswith("{") and sum(line.startswith("pgo devices=")
                                               for line in printed) == 2


def test_scaling_at_world_size_one_says_it_measures_no_scaling():
    out = scaling.main(["--what", "pgo", "--side", "6", "--device", "cpu"])
    assert out["world_size"] == 1 and [r["devices"] for r in out["pgo"]] == [1]
    assert "measures no scaling" in out["note"]


def test_init_multiprocess_refuses_nccl_on_the_cpu(tmp_path):
    with pytest.raises(ValueError, match="gloo"):
        multihost.init_multiprocess(0, 1, "file://" + str(tmp_path / "rdv"), backend="nccl",
                                    device="cpu")


def test_scene_store_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.HostShardedSceneStore(0, 2)
    store = multihost.HostShardedSceneStore(0, 2, "cpu")
    assert store.device == torch.device("cpu")
    store.put(0, (np.zeros((4, 2), np.float32),))
    store.put(1, (np.ones((4, 2), np.float32),))
    assert store.local_ids() == [0] and store.owner(1) == 1


def test_spawn_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        multihost.spawn_ranks(2, _fail_on_rank_one, device="cpu", timeout=120)


def _fail_on_rank_one(device):
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank one fails")
    return dist.get_rank()
