"""The benchmark's MULTI cell (``benchmark/``: the ``multi.dual`` cell, its
generator ``traffic/dual_passes.py``, its plain reference
``reference/multicue.py`` and the ``multi.*`` readers) and the spans and
counters of the port's multi-cue step, on the CPU at a small size: a front
(0.2, 0, 0) and a rear (-0.2, 0, pi) laser of 128 beams over 180 degrees
(``bench/synthetic.simulate``, seed 5), tracked on a 128-beam canvas over
+-pi, scene capacity 1,024, the LASER_0 tracking aligner.

Tolerances. The port's kernel 6 (its plain version, the CPU route) against
the reference: estimates within 1e-5 and counts equal. The two compute the
same operations except each cue's canvas, which the port builds with a
one-hot matrix product and the reference with scatter sums, so the mean of
tied points rounds differently in the last bit; the estimate moves by less
than 1e-6 for it here. The multi-cue step against the reference's step
from the same state: validity equal, points, normals and poses within 1e-5,
for the same reason.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import multicue, prep
from benchmark.trace import Trace
from benchmark.traffic import dual_passes
from srrg2_laser_slam_2d_tpu_torch.apps.synthetic_scene_generator import (
    dual_dataset_to_messages)
from srrg2_laser_slam_2d_tpu_torch.bench import synthetic
from srrg2_laser_slam_2d_tpu_torch.io.sources import ListSource, SynchronizedSource
from srrg2_laser_slam_2d_tpu_torch.models import tracker as tr
from srrg2_laser_slam_2d_tpu_torch.models.preprocessor import (LaserModel, PreprocessorConfig,
                                                               ScanPreprocessor)
from srrg2_laser_slam_2d_tpu_torch.models.runner import SlamRunner
from srrg2_laser_slam_2d_tpu_torch.ops import merge as merge_op
from srrg2_laser_slam_2d_tpu_torch.ops import multicue_align_kernel as mak
from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection
from srrg2_laser_slam_2d_tpu_torch.utils import cloud as cloud_op
from srrg2_laser_slam_2d_tpu_torch.utils import presets, profiling

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
BEAMS = 128
EXTR = np.array([(0.2, 0.0, 0.0), (-0.2, 0.0, np.pi)], np.float32)
FRAMES = ("laser_frame_0", "laser_frame_1")
PROJ = PolarProjection.make(cols=BEAMS, angle_min=-np.pi, angle_max=np.pi, range_min=0.3,
                            range_max=20.0)
TOL = 1e-5
NEW_METRICS = ("multi.cue_kernel_ms", "multi.cue_kernel_roofline", "multi.preprocess_ms",
               "multi.track_ms", "multi.clip_ms", "multi.align_ms", "multi.merge_ms",
               "multi.closure_s", "multi.launches_per_frame", "idle_pct.multi")
STEP_SPANS = ("tracker.multi.clip", "tracker.multi.align", "tracker.multi.merge")


def _tracker_config() -> tr.TrackerConfig:
    return tr.TrackerConfig(scene_capacity=1024, projection=PROJ,
                            aligner=presets.laser0_tracking_aligner(), use_fused_aligner=True)


def _ref_proj():
    return prep.PolarProjection(*PROJ)


def _ref_aligner(cfg: tr.TrackerConfig) -> dict:
    a = cfg.aligner
    return dict(iterations=a.max_iterations, point_distance=a.point_distance,
                normal_cos=a.normal_cos, chi_threshold=a.chi_threshold,
                min_inliers=a.min_num_inliers, min_corr=a.min_num_correspondences,
                odom_weight=a.odom_weight, damping=a.damping)


@pytest.fixture(scope="module")
def drive():
    """The two lasers' datasets of a 12-step circle drive, and its packs as
    cue-stacked clouds [C, N] with the odometry (ground truth) of each."""
    common = dict(steps=12, num_beams=BEAMS, max_variance=0.02,
                  drift=(0.15, 0.0, 2 * np.pi / 40), seed=5, angle_min=-np.pi / 2,
                  angle_max=np.pi / 2)
    dss = [synthetic.simulate(synthetic.SyntheticConfig(sensor_in_robot=tuple(e), **common),
                              "cpu") for e in EXTR]
    pre = ScanPreprocessor(PreprocessorConfig(voxelize_resolution=0.02, normal_window=8),
                           device="cpu")
    clouds = []
    for ds in dss:
        c = ds.config
        pre.set_model(LaserModel(c.num_beams, c.angle_min, c.angle_max, c.range_min,
                                 c.range_max))
        clouds.append(pre.compute(np.asarray(ds.ranges)))
    packs = [cloud_op.stack([c.map(lambda x: x[t]) for c in clouds])
             for t in range(len(dss[0].ranges))]
    return dss, packs, np.asarray(dss[0].robot_poses, np.float32)


def _align_inputs(drive, case: str):
    """Kernel 6's arguments for pack 1 against the clips of the scene seeded
    from pack 0: both cues, the front cue blanked, or the front cue with two-
    and three-way depth ties at its canvas's minima."""
    _, packs, poses = drive
    cfg = _tracker_config()
    extr = torch.from_numpy(EXTR)
    st = tr.populate_multi(cfg, tr.init_state(cfg), packs[0], extr)
    st = st._replace(last_odom=torch.from_numpy(poses[0]), has_odom=torch.tensor(True))
    moving, T0 = tr.multi_step_inputs(cfg, st, extr, torch.from_numpy(poses[1]),
                                      torch.tensor(True))
    fixed = packs[1]
    if case == "blank":
        fixed = fixed._replace(valid=fixed.valid.clone())
        fixed.valid[0] = False
    elif case == "ties":
        B = mak.cols_padded(PROJ)
        front = synthetic.with_tied_rows(fixed.map(lambda x: x[0]), 3,
                                         view=(PROJ, torch.zeros(3), B))
        assert {2, 3} <= synthetic.tie_counts(front, (PROJ, torch.zeros(3), B))
        rear = cloud_op.repad(fixed.map(lambda x: x[1]), front.xy.shape[0])
        fixed = cloud_op.stack([front, rear])
    args, kw = tr.fused_multi_arguments(cfg, fixed, extr, moving, T0)
    return cfg, args, kw


@pytest.mark.parametrize("case", ["both", "blank", "ties"])
def test_kernel6_cpu_route_matches_the_reference(drive, case):
    cfg, args, kw = _align_inputs(drive, case)
    got = mak.fused_projective_align_multi(*args, **kw)
    want = multicue.align_multi(_ref_proj(), *args[1:9], odom_prior=kw["odom_prior"],
                                **_ref_aligner(cfg))
    np.testing.assert_allclose(got.estimate.numpy(), want.estimate.numpy(), atol=TOL)
    assert float(want.num_inliers) >= 10
    assert float(got.num_corr) == float(want.num_corr)
    assert float(got.num_inliers) == float(want.num_inliers)
    np.testing.assert_array_equal(got.iter_stats[:, 1:3].numpy(),
                                  want.iter_stats[:, 1:3].numpy())


def test_reference_batch_matches_its_single_frames(drive):
    """The check replays a pass's launches as one batch: each frame of it
    as alone."""
    frames = [_align_inputs(drive, c) for c in ("both", "blank")]
    cfg = frames[0][0]
    args = [torch.stack(xs) for xs in zip(*(a[1:9] for _, a, _ in frames))]
    prior = torch.stack([kw["odom_prior"] for _, _, kw in frames])
    batch = multicue.align_multi(_ref_proj(), *args[:3], args[3][0], *args[4:],
                                 odom_prior=prior, **_ref_aligner(cfg))
    for i, (_, a, kw) in enumerate(frames):
        one = multicue.align_multi(_ref_proj(), *a[1:9], odom_prior=kw["odom_prior"],
                                   **_ref_aligner(cfg))
        np.testing.assert_allclose(batch.estimate[i].numpy(), one.estimate.numpy(), atol=1e-6)
        assert float(batch.num_inliers[i]) == float(one.num_inliers)


def test_multicue_steps_match_the_reference_step(drive):
    """Eight tracked frames of ``MultiCueTracker``, each step from the
    program's state before it through the reference's whole step."""
    _, packs, poses = drive
    cfg = _tracker_config()
    trk = tr.MultiCueTracker(cfg, EXTR, device="cpu")
    trk.compute(packs[0], poses[0])
    for k in range(1, 9):
        before = trk.state
        trk.compute(packs[k], poses[k])
        st = multicue.State(prep.Cloud(*before.scene), before.robot_in_local_map,
                            before.last_odom, before.has_odom)
        scene, pose = multicue.step(_ref_proj(), _ref_aligner(cfg), cfg.merge_threshold, st,
                                    prep.Cloud(*packs[k]), trk.extrinsics,
                                    torch.from_numpy(poses[k]), torch.tensor(True))
        got = trk.state
        np.testing.assert_array_equal(got.scene.valid.numpy(), scene.valid.numpy())
        np.testing.assert_allclose(got.scene.xy.numpy(), scene.xy.numpy(), atol=TOL)
        np.testing.assert_allclose(got.scene.normal.numpy(), scene.normal.numpy(), atol=TOL)
        np.testing.assert_allclose(got.robot_in_local_map.numpy(), pose.numpy(), atol=TOL)
    assert trk.steps == 8 and int(trk.state.scene.valid.sum()) > 2 * 100


def test_reference_loads_no_port_and_no_jax():
    code = ("import sys; import benchmark.reference.multicue; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', "
            "'srrg2_laser_slam_2d_tpu', 'srrg2_laser_slam_2d_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


# ------------------------------------------------------------ the cell

def _tiny(name: str = "multi.dual", packs: int = 24, cell_of=harness.Cell) -> harness.Cell:
    """The cell cut to its first ``packs`` packs, two copies; such a pass
    closes no loop, so passes without closures are let through."""
    cell = cell_of(name)
    cell.mix = dict(cell.mix, max_packs=packs, warm_packs=packs, copies=2)
    cell.limits = dict(cell.limits, frames_checked=8,
                       limits=dict(cell.limits["limits"], passes_without_closures=99))
    return cell


def test_dual_passes_through_the_harness_on_the_cpu():
    """``harness.main`` with ``device="cpu"`` over the first 24 packs, in a
    process of its own (the harness refuses a run that loaded JAX, which
    this test process has)."""
    code = ("import sys, time; t0 = time.perf_counter(); "
            "from benchmark import harness; "
            "from tests.test_torch_multicue_bench import _tiny; "
            "harness.Cell = lambda n: _tiny(n); "
            "sys.exit(harness.main(['--workload', 'multi.dual', '--seed', str(2**31 + 4321), "
            "'--seconds', '0.3', '--trace', '0'], t0, device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] >= 0, res
    assert set(res["metrics"]) == {"map_frames_per_s", "setup_s"}
    assert res["metrics"]["map_frames_per_s"]["value"] > 0
    assert res["device"]["platform"] == "cpu"
    assert res["check"]["cue_estimate_off_share"]["value"] == 0.0


def test_the_log_is_held_to_its_sha256(tmp_path):
    mix = harness.Cell("multi.dual").mix
    for key in ("log", "ground_truth"):
        assert hashlib.sha256((ROOT / mix[key]).read_bytes()).hexdigest() == mix["sha256"][key]
    cut = tmp_path / "log.jsonl"
    cut.write_text("".join((ROOT / mix["log"]).read_text().splitlines(True)[:40]))
    cell = harness.Cell("multi.dual")
    cell.mix = dict(mix, log=str(cut))
    with pytest.raises(RuntimeError, match="not the file"):
        dual_passes.setup(cell, 1, CPU)


def _nudged(monkeypatch):
    real = mak.fused_projective_align_multi

    def fault(*a, **kw):
        out = real(*a, **kw)
        return out._replace(estimate=out.estimate + 1e-2)
    monkeypatch.setattr(mak, "fused_projective_align_multi", fault)


def _rear_merge_skipped(monkeypatch):
    real, calls = merge_op.merge_projective, [0]

    def fault(proj, scene, *a, **kw):
        calls[0] += 1
        # the multi-cue step merges the front cue, then the rear cue
        return scene if calls[0] % 2 == 0 else real(proj, scene, *a, **kw)
    monkeypatch.setattr(merge_op, "merge_projective", fault)


@pytest.mark.parametrize("fault", [None, _nudged, _rear_merge_skipped])
def test_planted_faults_turn_correct_false(fault, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    out = harness.measure(_tiny(), 2**31 + 77, 0.3, False, CPU, time.perf_counter())
    assert out["correct"] == (fault is None), out["check"]


# ------------------------------------------------------ spans, counters

@pytest.fixture(scope="module")
def dual_messages(drive):
    dss, _, _ = drive
    return dual_dataset_to_messages(*dss, frames=FRAMES, odom_noise=0.02, seed=5)


def _multi_run(msgs) -> SlamRunner:
    slam_cfg = presets.multi_slam(BEAMS, 1024, cue_extrinsics=EXTR, use_fused_aligner=True)
    assert slam_cfg.tracker == _tracker_config()
    runner = SlamRunner(slam_config=slam_cfg,
                        preprocessor_config=PreprocessorConfig(voxelize_resolution=0.02,
                                                               normal_window=8),
                        scan_topics=["/scan_0", "/scan_1"], sensor_frames=list(FRAMES),
                        base_frame="base_frame", device="cpu")
    runner.run(SynchronizedSource(ListSource(msgs), ["/tf", "/odom", "/scan_0", "/scan_1"],
                                  time_interval=0.1))
    return runner


def test_step_spans_nest_inside_the_frame_and_sum_to_at_most_it(dual_messages, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        runner = _multi_run(dual_messages)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    steps = runner.slam.tracker.steps
    assert steps >= 8
    for name in STEP_SPANS:
        assert len(spans[name]) == steps, name
        for a, b in spans[name]:
            assert any(pa <= a and b <= pb for pa, pb in spans["slam.track"]), name
    pt = runner.slam.phase_times
    assert 0.0 < pt["track.clip"] + pt["track.align"] + pt["track.merge"] <= pt["track"]


def test_step_spans_off_neither_annotate_nor_synchronise(dual_messages, monkeypatch):
    calls = []
    monkeypatch.setattr(profiling, "_sync", lambda d: calls.append(("sync", d)))
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(("annotation", name)))
    runner = _multi_run(dual_messages)
    assert calls == []
    assert runner.slam.phase_times["track.align"] > 0.0


def test_counters_count_frames_launches_and_rows(dual_messages):
    before = (tr.multi_frames, mak.launches, mak.moving_rows, mak.fixed_rows)
    runner = _multi_run(dual_messages)
    assert tr.multi_frames - before[0] == runner.slam.tracker.steps >= 8
    # the CPU route runs the plain version: no launch and no rows
    assert (mak.launches, mak.moving_rows, mak.fixed_rows) == before[1:]


# ------------------------------------------------------------ readers

class _Run:
    def __init__(self, passes=(), counters=None):
        self.passes = list(passes)
        self.counters = counters or {}
        self.info = {"cues": 2, "iterations": 10}


def _read(name, run, trace):
    return harness.metric_reader(name)(harness.Context("multi.dual", run, trace))


def _trace(device=(), annotations=None) -> Trace:
    return Trace(device=list(device), annotations=annotations or {}, window=(0.0, 1000.0))


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_readers_return_none_with_nothing_to_read(name):
    parent_counters = {"start": dict.fromkeys(("launches", "moving_rows", "fixed_rows",
                                               "multi_frames")),
                       "end": dict.fromkeys(("launches", "moving_rows", "fixed_rows",
                                             "multi_frames"))}
    assert _read(name, _Run(), None) is None
    # a trace with no kernel 6 and none of the spans (no device work at all
    # for the idle share, which reads no span), a program without the counters
    device = [] if name == "idle_pct.multi" else [("some_other_kernel", 10.0, 20.0, 1)]
    other = _trace(device, {"bench.window": [(0.0, 1000.0)], "runner.flush": [(5.0, 50.0)]})
    assert _read(name, _Run(counters=parent_counters), other) is None


def test_new_readers_read_a_hand_built_trace():
    ann = {"slam.track": [(100.0, 300.0), (400.0, 600.0)],
           "runner.preprocess": [(10.0, 20.0), (20.0, 40.0), (310.0, 320.0), (320.0, 330.0)],
           "tracker.multi.clip": [(110.0, 130.0), (410.0, 440.0)],
           "tracker.multi.align": [(130.0, 140.0), (440.0, 450.0)],
           "tracker.multi.merge": [(140.0, 200.0), (450.0, 470.0)]}
    dev = [("void multicue_align_kernel(float const*)", 135.0, 185.0, 1),
           ("void multicue_align_kernel(float const*)", 445.0, 515.0, 2)]
    counters = {"start": {"launches": 3, "moving_rows": 3 * 1442, "fixed_rows": 3 * 1442,
                          "multi_frames": 3},
                "end": {"launches": 5, "moving_rows": 5 * 1442, "fixed_rows": 5 * 1442,
                        "multi_frames": 5}}
    run = _Run([{"phases": {"track": 9.0, "detect": 1.0, "vote": 2.0, "solve": 0.5}},
                {"phases": {"relocalize": 0.5, "split": 1.0}}], counters)
    tr_ = _trace(dev, ann)
    got = {n: _read(n, run, tr_) for n in NEW_METRICS}
    assert got["multi.cue_kernel_ms"] == pytest.approx(0.06)
    assert got["multi.preprocess_ms"] == pytest.approx(0.025)      # 50 us over 2 frames
    assert got["multi.track_ms"] == pytest.approx(0.2)
    assert got["multi.clip_ms"] == pytest.approx(0.025)
    assert got["multi.align_ms"] == pytest.approx(0.01)
    assert got["multi.merge_ms"] == pytest.approx(0.04)
    assert got["multi.closure_s"] == pytest.approx(2.5)
    assert got["multi.launches_per_frame"] == pytest.approx(1.0)
    assert got["idle_pct.multi"] == pytest.approx(100.0 * (1 - 0.12))
    flops = 11 * 2 * (110 * 1442 + 60)
    assert got["multi.cue_kernel_roofline"] == pytest.approx(
        100.0 * max(flops / 67e12, (17 * 2884 + 4 * 12 + 4 * 48) / 3.35e12) / 60e-6)
