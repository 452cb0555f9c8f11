"""``ops/icp.align`` on its two routes: eager, one PyTorch operation at a
time, and on the card one replay of a captured CUDA graph of the whole
iteration chain (``icp.graph_route``; a key captured at its second call),
the counters ``graph_captures`` / ``graph_replays`` / ``eager_card_calls``
and the two benchmark readers over them.

The CPU tests need no card. The tests marked ``cuda`` hold the graph
route bitwise equal to ``icp._align_eager`` on the card: both run the same
kernels in the same order in float32. They import neither JAX nor the JAX
package:

    python -m pytest tests/test_torch_align_graph.py -q -p no:randomly --noconftest
"""

from __future__ import annotations

import json
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from srrg2_laser_slam_2d_tpu_torch.io.sources import (JsonlFileSource, ListSource,
                                                      SynchronizedSource)
from srrg2_laser_slam_2d_tpu_torch.models import loop_closure as lc
from srrg2_laser_slam_2d_tpu_torch.models.runner import SlamRunner
from srrg2_laser_slam_2d_tpu_torch.ops import icp
from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection
from srrg2_laser_slam_2d_tpu_torch.utils import cloud as cloud_op
from srrg2_laser_slam_2d_tpu_torch.utils import config as config_mod
from srrg2_laser_slam_2d_tpu_torch.utils.cloud import Cloud

ROOT = Path(__file__).resolve().parent.parent
MULTI_CONFIG = ROOT / "benchmark" / "configs" / "multi_segway.json"
DUAL_LOG = ROOT / "benchmark" / "data" / "dual_circle.jsonl"
COUNTERS = ("graph_captures", "graph_replays", "eager_card_calls")


def _counters() -> tuple:
    return tuple(getattr(icp, k) for k in COUNTERS)


def _room(cap: int, n: int, pose, seed: int, device="cpu") -> Cloud:
    """``n`` points on the walls of a 6 x 4 m room seen from ``pose``
    (x, y, theta), inward normals, N(0, 5 mm) noise, padded to ``cap``."""
    rng = np.random.default_rng(seed)
    side = rng.integers(0, 4, n)
    u = rng.uniform(-1.0, 1.0, n)
    xy = np.stack([np.where(side < 2, u * 3.0, np.where(side == 2, -3.0, 3.0)),
                   np.where(side < 2, np.where(side == 0, -2.0, 2.0), u * 2.0)], -1)
    normal = np.stack([np.where(side < 2, 0.0, np.where(side == 2, 1.0, -1.0)),
                       np.where(side < 2, np.where(side == 0, 1.0, -1.0), 0.0)], -1)
    xy = xy + rng.normal(0.0, 0.005, xy.shape)
    x, y, t = pose
    c, s = math.cos(t), math.sin(t)
    d = xy - np.array([x, y])
    local = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], -1)
    nloc = np.stack([c * normal[:, 0] + s * normal[:, 1],
                     -s * normal[:, 0] + c * normal[:, 1]], -1)
    out = np.zeros((cap, 2), np.float32), np.zeros((cap, 2), np.float32)
    out[0][:n], out[1][:n] = local, nloc
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return Cloud(torch.from_numpy(out[0]).to(device), torch.from_numpy(out[1]).to(device),
                 torch.from_numpy(valid).to(device))


def _equal(a: icp.AlignResult, b: icp.AlignResult) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


PROJ = PolarProjection.make(181, -math.pi, math.pi, 0.1, 20.0)


def _case(K: int, seed: int, device="cpu"):
    """K room scans against one query scan, initials off by a few cm."""
    fixed = cloud_op.stack([_room(512, 400, (0.1 * k, 0.05 * k, 0.02 * k), seed + k, device)
                    for k in range(K)])
    moving = _room(512, 380, (0.3, -0.1, 0.05), seed + 100, device)
    initials = torch.tensor([[0.3 - 0.1 * k + 0.03, -0.1 - 0.05 * k - 0.02, 0.03 - 0.02 * k]
                             for k in range(K)], dtype=torch.float32, device=device)
    return fixed, moving, initials


# ---------------------------------------------------------------- CPU tests
@pytest.mark.parametrize("K", [1, 3])
def test_cpu_align_is_eager_and_counts_nothing(K):
    fixed, moving, initials = _case(K, 7 * K)
    cfg = lc.default_ld_aligner()
    before = _counters()
    res = icp.align(cfg, PROJ, fixed, moving, initials)
    assert _counters() == before
    assert _equal(res, icp._align_eager(cfg, PROJ, fixed, moving, initials))
    # a real alignment: the room is found
    assert int(res.num_inliers.min()) > 100
    assert res.estimate.shape == (K, 3) and res.stats.shape == (K, cfg.max_iterations, 4)


def test_cpu_align_with_prior_is_eager():
    fixed, moving, initials = _case(1, 3)
    cfg = icp.AlignerConfig(max_iterations=10)
    prior = initials[0] + 0.01
    before = _counters()
    res = icp.align(cfg, PROJ, fixed.map(lambda x: x[0]), moving, initials[0], odom_prior=prior)
    assert _counters() == before
    assert _equal(res, icp._align_eager(cfg, PROJ, fixed.map(lambda x: x[0]), moving,
                                        initials[0], odom_prior=prior))


@pytest.mark.parametrize("change,graphed", [
    ({}, True),
    ({"epsilon": 1e-4}, False),
    ({"finder": "nn_grid"}, False),
    ({"finder": "bruteforce"}, False),
    ({"max_iterations": 10, "odom_weight": 1.0, "enable_inlier_only_runs": True,
      "keep_only_inlier_correspondences": True}, True),
])
def test_route_rule(change, graphed):
    import dataclasses

    cfg = dataclasses.replace(lc.default_ld_aligner(), **change)
    assert icp.graph_route(cfg, torch.device("cuda")) is graphed
    assert icp.graph_route(cfg, torch.device("cuda", 1)) is graphed
    assert icp.graph_route(cfg, torch.device("cpu")) is False


def _fake_card(monkeypatch) -> list:
    """The graph route on CPU tensors, with ``_align_eager`` and the capture
    recorded instead of run: returns the log of ("eager" | "capture" |
    "replay", K) entries."""
    import contextlib

    log: list = []
    eager = icp._align_eager

    def recording_eager(cfg, proj, fixed, moving, initial, odom_prior=None):
        log.append(("eager", initial.shape[0]))
        return eager(cfg, proj, fixed, moving, initial, odom_prior)

    def capture(cfg, proj, inputs):
        res = eager(cfg, proj, Cloud(*inputs[:3]), Cloud(*inputs[3:6]), inputs[6])
        log.append(("capture", inputs[6].shape[0]))
        graph = types.SimpleNamespace(replay=lambda: log.append(("replay", inputs[6].shape[0])))
        return icp._Captured(graph, tuple(t.clone() for t in inputs), res, {})

    monkeypatch.setattr(icp, "graph_route", lambda cfg, device: True)
    monkeypatch.setattr(icp, "_align_eager", recording_eager)
    monkeypatch.setattr(icp, "_capture", capture)
    monkeypatch.setattr(icp, "_GRAPHS", {})
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    return log


def test_a_key_is_captured_at_its_second_call_and_replayed_after(monkeypatch):
    """A key's first call runs eagerly, its second captures and replays,
    later ones replay; another shape is another key. A shape seen once
    costs no capture."""
    log = _fake_card(monkeypatch)
    cfg = lc.default_ld_aligner()
    one, three = _case(1, 5), _case(3, 5)
    c0 = _counters()
    for K, case in ((1, one), (1, one), (3, three), (1, one), (1, one), (3, three)):
        res = icp.align(cfg, PROJ, *case)
        assert res.estimate.shape == (K, 3)
    assert log == [("eager", 1), ("capture", 1), ("replay", 1), ("eager", 3),
                   ("replay", 1), ("replay", 1), ("capture", 3), ("replay", 3)]
    assert _counters() == (c0[0] + 2, c0[1] + 2, c0[2] + 2)
    assert len(icp._GRAPHS) == 2 and all(e is not None for e in icp._GRAPHS.values())
    # the key holds the batch, both capacities and the prior's presence
    prior = one[2] + 0.01
    icp.align(cfg, PROJ, *one, odom_prior=prior)
    icp.align(cfg, PROJ, one[0].map(lambda x: x[:, :256]), one[1], one[2])
    assert log[-2:] == [("eager", 1), ("eager", 1)] and len(icp._GRAPHS) == 4


def test_counter_moves_of_the_kernel_wrappers_are_counted_again(monkeypatch):
    """``_cuda.counters`` reads every loaded wrapper's lowercase int and
    Counter globals; what moved is added once more by ``count_again``."""
    from collections import Counter

    from srrg2_laser_slam_2d_tpu_torch.ops import _cuda, nn_icp_kernel, projector_kernel

    monkeypatch.setattr(projector_kernel, "launches", 5)
    monkeypatch.setattr(projector_kernel, "calls", Counter({(8192, 1): 2}))
    monkeypatch.setattr(nn_icp_kernel, "pairs", 0)
    before = _cuda.counters()
    assert before[projector_kernel, "launches"] == 5
    assert all(k[:1].islower() for _, k in before)
    projector_kernel.launches += 3
    projector_kernel.calls[(721, 1)] += 2
    projector_kernel.calls[(8192, 1)] += 1
    moves = _cuda.counter_moves(before)
    assert moves == {(projector_kernel, "launches"): 3,
                     (projector_kernel, "calls"): Counter({(721, 1): 2, (8192, 1): 1})}
    _cuda.count_again(moves)
    assert projector_kernel.launches == 11
    assert projector_kernel.calls == Counter({(8192, 1): 4, (721, 1): 4})
    assert nn_icp_kernel.pairs == 0
    assert _cuda.counter_moves(_cuda.counters()) == {}


def _read(name: str, run) -> float | None:
    return harness.metric_reader(name)(harness.Context("multi.dual", run, None))


def test_relocalize_reader_averages_the_window_passes():
    run = types.SimpleNamespace(passes=[
        {"phases": {"relocalize": 1.5, "detect": 0.25, "solve": 0.5}},
        {"phases": {"relocalize": 2.5, "split": 0.125}},
        {"phases": {"track": 3.0}},
    ])
    assert _read("multi.relocalize_s", run) == pytest.approx(4.0 / 3)
    assert _read("multi.relocalize_s", types.SimpleNamespace(passes=[])) is None
    assert _read("multi.relocalize_s", types.SimpleNamespace()) is None


@pytest.mark.parametrize("counts,share", [
    ((2, 40, 0), 40 / 42),
    ((3, 90, 7), 0.9),
    ((0, 0, 5), 0.0),
    ((0, 0, 0), None),
])
def test_replay_share_reader(monkeypatch, counts, share):
    for k, v in zip(COUNTERS, counts):
        monkeypatch.setattr(icp, k, v)
    got = _read("multi.closure_align_replay_share", types.SimpleNamespace(passes=[]))
    assert got == (None if share is None else pytest.approx(share))


@pytest.mark.parametrize("missing", COUNTERS)
def test_replay_share_reader_without_the_counters(monkeypatch, missing):
    """The parent commit has no such counters: the reader finds nothing."""
    monkeypatch.delattr(icp, missing)
    assert _read("multi.closure_align_replay_share", types.SimpleNamespace(passes=[])) is None


# --------------------------------------------------------------- card tests
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from srrg2_laser_slam_2d_tpu_torch._device import resolve_device

    return resolve_device("cuda")


def _multi_runner(device) -> tuple[SlamRunner, SynchronizedSource]:
    """The ``multi.dual`` cell's configuration over its log."""
    config = json.loads(MULTI_CONFIG.read_text())
    mgr = config_mod.ConfigManager.read(str(MULTI_CONFIG))
    kw = config["runner"]
    runner = SlamRunner(slam_config=mgr.get_by_name("slam"),
                        preprocessor_config=mgr.get_by_name("preprocessor"),
                        scan_topics=list(kw["scan_topics"]),
                        sensor_frames=list(kw["sensor_frames"]),
                        base_frame=kw["base_frame"], odom_topic=kw["odom_topic"], device=device)
    source = SynchronizedSource(ListSource(list(JsonlFileSource(str(DUAL_LOG)))),
                                kw["sync_topics"], time_interval=kw["sync_interval"])
    return runner, source


def _multi_run(device, packs: int, calls: list | None = None) -> SlamRunner:
    """``packs`` packs of the dual drive; ``calls`` collects every
    ``lc._batch_align`` call's inputs (cloned) and result."""
    runner, source = _multi_runner(device)
    align = lc._batch_align

    def recording(acfg, proj, fixed, moving, initials):
        held = (fixed.map(torch.clone), moving.map(torch.clone), initials.clone())
        res = align(acfg, proj, fixed, moving, initials)
        calls.append((acfg, proj) + held + (res,))
        return res

    if calls is not None:
        lc._batch_align = recording
    try:
        for i, pack in enumerate(source):
            if i >= packs:
                break
            runner.put_message(pack)
    finally:
        lc._batch_align = align
    return runner


@pytest.fixture(scope="module")
def drive(card):
    """120 packs of the dual drive on the graph route: the runner and
    every relocalizer / detector alignment it made."""
    calls: list = []
    runner = _multi_run(card, 120, calls)
    torch.cuda.synchronize()
    assert calls and all(c[2].capacity == 8192 for c in calls)
    return runner, calls


def _fresh_cache(monkeypatch):
    monkeypatch.setattr(icp, "_GRAPHS", {})


@pytest.mark.cuda
def test_graph_equals_eager_on_the_drive_alignments(card, drive, monkeypatch):
    """The drive's relocalizer and detector calls as made (K = 1, 2, 3)
    and one query scene against three of its maps, at capacity 8,192:
    every field bitwise equal."""
    _fresh_cache(monkeypatch)
    runner, calls = drive
    for acfg, proj, fixed, moving, initials, res in calls:
        assert _equal(res, icp._align_eager(acfg, proj, fixed, moving, initials))
        assert _equal(icp.align(acfg, proj, fixed, moving, initials), res)
    slam = runner.slam
    maps = [m for m in range(slam.n_maps) if slam.scenes[m] is not None][:3]
    assert len(maps) == 3
    acfg, proj, _, moving, _, _ = calls[-1]
    poses = slam.poses_np
    fixed = cloud_op.stack([slam.scenes[m] for m in maps])
    initials = torch.from_numpy(np.stack([lc.relative_np(poses[m], poses[maps[0]])
                                          for m in maps])).to(card)
    eager = icp._align_eager(acfg, proj, fixed, moving, initials)
    for _ in range(3):      # eager, capture, replay
        assert _equal(icp.align(acfg, proj, fixed, moving, initials), eager)


@pytest.mark.cuda
def test_graph_equals_eager_with_prior_on_the_tracker_config(card, drive, monkeypatch):
    """The tracker's 10-iteration aligner with the odometry prior, one
    scene pair (no batch), as the plain tracker's route calls it."""
    _fresh_cache(monkeypatch)
    runner, calls = drive
    acfg = runner.slam.cfg.tracker.aligner
    assert acfg.max_iterations == 10 and acfg.odom_weight > 0 and icp.graph_route(acfg, card)
    _, proj, fixed, moving, initials, _ = calls[0]
    fixed = fixed.map(lambda x: x[0])
    for shift in (0.0, 0.02, -0.05):
        initial = initials[0] + shift
        prior = initials[0] - shift
        eager = icp._align_eager(acfg, proj, fixed, moving, initial, odom_prior=prior)
        assert _equal(icp.align(acfg, proj, fixed, moving, initial, odom_prior=prior), eager)


@pytest.mark.cuda
def test_graph_buffers_are_never_stale_and_results_never_alias(card, drive, monkeypatch):
    """One key's calls on two inputs in turn: each equals its own eager
    result, and no result changes at a later replay. The counters read an
    eager first call, one capture, then replays."""
    _fresh_cache(monkeypatch)
    _, calls = drive
    acfg, proj, fixed, moving, initials, _ = calls[0]
    other = next(c for c in calls[1:] if not torch.equal(c[3].xy, moving.xy))
    mine = (fixed, moving, initials)
    theirs = other[2:5]
    mine_eager = icp._align_eager(acfg, proj, *mine)
    theirs_eager = icp._align_eager(acfg, proj, *theirs)
    assert not torch.equal(mine_eager.estimate, theirs_eager.estimate)
    c0 = _counters()
    first = icp.align(acfg, proj, *mine)
    assert _counters() == (c0[0], c0[1], c0[2] + 1)
    second = icp.align(acfg, proj, *theirs)
    assert _counters() == (c0[0] + 1, c0[1], c0[2] + 1)
    kept = icp.AlignResult(*(t.clone() for t in second))
    third = icp.align(acfg, proj, *mine)
    assert _counters() == (c0[0] + 1, c0[1] + 1, c0[2] + 1)
    fourth = icp.align(acfg, proj, *theirs)
    assert _counters() == (c0[0] + 1, c0[1] + 2, c0[2] + 1)
    assert _equal(first, mine_eager) and _equal(third, mine_eager)
    assert _equal(second, kept) and _equal(second, theirs_eager)
    assert _equal(fourth, theirs_eager)


@pytest.mark.cuda
def test_kernel_counters_on_the_graph_route(card, drive, monkeypatch):
    """With the projector kernel's z-buffers (route C's backend) a replay
    counts the kernel's launches and calls as the eager route does."""
    from collections import Counter

    from srrg2_laser_slam_2d_tpu_torch.ops import projector as projector_op
    from srrg2_laser_slam_2d_tpu_torch.ops import projector_kernel

    _fresh_cache(monkeypatch)
    monkeypatch.setattr(projector_op, "ZBUFFER_BACKEND", "kernel")
    monkeypatch.setattr(projector_kernel, "launches", 0)
    monkeypatch.setattr(projector_kernel, "calls", Counter())
    _, calls = drive
    acfg, proj, fixed, moving, initials, _ = calls[0]
    eager = icp._align_eager(acfg, proj, fixed, moving, initials)
    one = (projector_kernel.launches, Counter(projector_kernel.calls))
    assert one[0] > 0
    c0 = _counters()
    for _ in range(4):      # eager, capture, replay, replay
        assert _equal(icp.align(acfg, proj, fixed, moving, initials), eager)
    assert _counters() == (c0[0] + 1, c0[1] + 2, c0[2] + 1)
    # the capture's call is counted twice: its warm-up and its replay
    assert projector_kernel.launches == 6 * one[0]
    assert projector_kernel.calls == Counter({k: 6 * v for k, v in one[1].items()})


@pytest.mark.cuda
def test_eager_route_on_the_card_is_counted(card, drive, monkeypatch):
    import dataclasses

    _, calls = drive
    acfg, proj, fixed, moving, initials, _ = calls[0]
    eps = dataclasses.replace(acfg, epsilon=1e-4)
    c0 = _counters()
    res = icp.align(eps, proj, fixed, moving, initials)
    assert _counters() == (c0[0], c0[1], c0[2] + 1)
    assert _equal(res, icp._align_eager(eps, proj, fixed, moving, initials))


@pytest.mark.cuda
def test_multi_run_equals_on_both_routes(card, monkeypatch):
    """120 packs of the MULTI loop with the graph route and with eager
    mode forced: the same relocalizations, closures and maps, and the same
    trajectory to the bit. Both runs use deterministic algorithms: the
    loop's ``index_add_`` sums (the voxel means, the dense solve's
    assembly) are atomics on the card and differ from run to run on
    either route otherwise."""
    _fresh_cache(monkeypatch)
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        calls: list = []
        graphed = _multi_run(card, 120, calls)
        c0 = _counters()
        with monkeypatch.context() as m:
            m.setattr(icp, "graph_route", lambda cfg, device: False)
            eager = _multi_run(card, 120)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
    assert _counters()[:2] == c0[:2] and _counters()[2] == c0[2] + len(calls)
    a, b = graphed.slam, eager.slam
    assert a.relocalizations == b.relocalizations > 0
    assert a.num_closures == b.num_closures > 0
    assert (a.num_variables(), a.num_factors()) == (b.num_variables(), b.num_factors())
    np.testing.assert_array_equal(a.poses_np, b.poses_np)
    ta = np.stack([np.asarray(p) for _, p, _ in graphed.trajectory])
    tb = np.stack([np.asarray(p) for _, p, _ in eager.trajectory])
    assert ta.shape == tb.shape and ta.shape[0] > 100
    np.testing.assert_array_equal(ta, tb)
