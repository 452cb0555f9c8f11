"""The port's span recorder and counters (srrg2_laser_slam_2d_tpu_torch:
``utils/profiling.timed`` and ``span``, the spans of
``models/chunked_slam.py``, ``models/slam.py``, ``models/loop_closure.py``,
``models/fast_tracker.py`` and ``ops/stream_kernel.py``; the counters
``ops/nn_icp_kernel.pairs`` and ``solver/pgo.solves`` / ``iterations``) on
the host, with the plain versions.

With tracing off a span enters no ``record_function`` and synchronises
nothing, even for a CUDA device. Under ``torch.profiler.profile()`` a small
chunked drive (the noisy loop of ``tests/test_torch_chunked_slam.py``: 44
steps, 512 beams, chunk 16, the ``fused_nn`` detector aligning 512 points a
scene, validator and relocalizer on) and a per-message drive on route D
(local maps 1 m apart) open every span as a ``user_annotation``, each child
inside its parent, and leave the trajectory and the graph as they are with
tracing off."""

import json

import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu_torch.apps.synthetic_scene_generator import dataset_to_messages
from srrg2_laser_slam_2d_tpu_torch.bench import stream_bench, synthetic
from srrg2_laser_slam_2d_tpu_torch.models import chunked_slam, fast_tracker
from srrg2_laser_slam_2d_tpu_torch.models import loop_closure as lc
from srrg2_laser_slam_2d_tpu_torch.models import tracker as tracker_mod
from srrg2_laser_slam_2d_tpu_torch.models.preprocessor import PreprocessorConfig
from srrg2_laser_slam_2d_tpu_torch.models.runner import SlamRunner
from srrg2_laser_slam_2d_tpu_torch.models.slam import GraphSLAMConfig
from srrg2_laser_slam_2d_tpu_torch.ops import icp, nn_icp_kernel
from srrg2_laser_slam_2d_tpu_torch.ops import stream_kernel as sk
from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection
from srrg2_laser_slam_2d_tpu_torch.solver import pgo
from srrg2_laser_slam_2d_tpu_torch.utils import profiling

CHUNK = 16
PRE = PreprocessorConfig(voxelize_resolution=0.02, normal_window=8)

# span -> the span it lies in (None: outermost)
CHUNKED_SPANS = {
    "runner.flush": None,
    "runner.preprocess": "runner.flush",
    "slam.track": "runner.flush",
    "slam.materialize": "runner.flush",
    "tracker.materialize": "slam.materialize",
    "slam.closure": "runner.flush",
    "slam.detect": "slam.closure",
    "slam.detect.select": "slam.detect",
    "slam.detect.align": "slam.detect",
    "slam.detect.gate": "slam.detect",
    "slam.vote": "slam.closure",
    "slam.vote.solve": "slam.vote",
    "slam.merge": "slam.closure",
    "slam.solve": "slam.closure",
    "slam.relocalize": "slam.closure",
}
MESSAGE_SPANS = {
    "runner.preprocess": None,
    "slam.track": None,
    "slam.relocalize": None,
    "slam.split": None,
    "slam.detect": None,
    "slam.vote": None,
    "slam.vote.solve": "slam.vote",
    "slam.merge": None,
}
OLD_KEYS = {"track", "materialize", "detect", "vote", "merge", "solve", "relocalize"}
NEW_KEYS = {"preprocess", "detect.select", "detect.align", "detect.gate", "vote.solve"}


def _config(local_map_distance=0.5, detection_capacity=0, **kw) -> GraphSLAMConfig:
    """``tests/test_slam.py:make_pipeline``'s settings in the port's classes,
    loops, validator and relocalizer on."""
    proj = PolarProjection.make(cols=512, angle_min=-np.pi, angle_max=np.pi,
                                range_min=0.1, range_max=30.0)
    return GraphSLAMConfig(
        local_map_distance=local_map_distance, var_capacity=64, edge_capacity=128,
        tracker=tracker_mod.TrackerConfig(
            scene_capacity=2048, projection=proj,
            aligner=icp.AlignerConfig(max_iterations=8, point_distance=0.5, normal_cos=0.8)),
        detector=lc.LoopDetectorConfig(
            relocalize_min_inliers=60, relocalize_min_inliers_ratio=0.5,
            relocalize_max_chi_inliers=0.1, max_candidates=4,
            aligner=icp.AlignerConfig(max_iterations=15, point_distance=1.414,
                                      normal_cos=0.8, chi_threshold=0.05, odom_weight=0.0),
            backend="fused_nn", fused_corr_refresh=3,
            detection_capacity=detection_capacity),
        validator=lc.ValidatorConfig(enabled=True, min_times_checked=1),
        enable_loop_closure=True, enable_relocalizer=True, **kw)


@pytest.fixture(scope="module")
def messages():
    ds = synthetic.simulate(synthetic.SyntheticConfig(
        steps=44, num_beams=512, max_variance=0.02,
        drift=(0.15, 0.0, 2 * np.pi / 40), seed=7), device="cpu")
    return ds, dataset_to_messages(ds)


class _Drive:
    """One drive's outcome: the runner, its loop, the jobs ``select_many``
    returned and the counters' rises."""

    def __init__(self, runner, jobs, rises):
        self.runner, self.slam, self.jobs, self.rises = runner, runner.slam, jobs, rises


def _counters():
    return nn_icp_kernel.pairs, nn_icp_kernel.launches, pgo.solves, pgo.iterations


def _chunked_drive(messages, monkeypatch) -> _Drive:
    ds, msgs = messages
    jobs = []
    select_many = lc.BreadthFirstSelector.select_many

    def recorded(self, *a):
        out = select_many(self, *a)
        jobs.extend(out)
        return out

    monkeypatch.setattr(lc.BreadthFirstSelector, "select_many", recorded)
    before = _counters()
    runner = chunked_slam.ChunkedSlamRunner(
        slam_config=_config(detection_capacity=512), preprocessor_config=PRE, chunk=CHUNK,
        scan_topic="/scan", sensor_in_robot=np.array(ds.config.sensor_in_robot, np.float32),
        device="cpu")
    runner.run(msgs)
    monkeypatch.setattr(lc.BreadthFirstSelector, "select_many", select_many)
    return _Drive(runner, jobs, [b - a for a, b in zip(before, _counters())])


def _message_drive(messages) -> _Drive:
    ds, msgs = messages
    runner = SlamRunner(slam_config=_config(1.0, use_fast_tracker=True),
                        preprocessor_config=PRE, scan_topic="/scan",
                        sensor_in_robot=np.array(ds.config.sensor_in_robot, np.float32),
                        device="cpu")
    runner.run(msgs)
    return _Drive(runner, [], [])


def _annotations(prof, tmp_path, name: str) -> dict:
    """The profile's ``user_annotation`` events: name -> [(start, end)]."""
    path = tmp_path / f"{name}.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            out.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + e["dur"]))
    return out


@pytest.fixture(scope="module")
def drives(messages, tmp_path_factory):
    """Each drive with tracing off, then under the profiler (its spans)."""
    tmp = tmp_path_factory.mktemp("traces")
    with pytest.MonkeyPatch.context() as mp:
        off = _chunked_drive(messages, mp)
        msg_off = _message_drive(messages)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            on = _chunked_drive(messages, mp)
        chunked_spans = _annotations(prof, tmp, "chunked")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            msg_on = _message_drive(messages)
        message_spans = _annotations(prof, tmp, "message")
    return off, on, chunked_spans, msg_off, msg_on, message_spans


def test_a_span_with_tracing_off_neither_annotates_nor_synchronises(monkeypatch):
    entered, synced = [], []

    class Annotation:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Annotation)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    monkeypatch.setattr(profiling, "enable_logging", False)
    assert not profiling.tracing()
    times: dict = {}
    for _ in range(2):
        with profiling.timed("slam.detect.select", "cuda", times, "detect.select") as t:
            pass
    assert entered == [] and synced == []
    assert set(times) == {"detect.select"} and times["detect.select"] >= t.seconds >= 0.0
    assert profiling.span("slam.split")(lambda x: x + 1)(1) == 2 and entered == []
    # tracing on: the annotation, and the synchronise where a CUDA device is given
    monkeypatch.setattr(profiling, "enable_logging", True)
    profiling.reset()
    with profiling.timed("slam.solve", "cuda", times, "solve"):
        pass
    with profiling.timed("slam.vote.solve", times=times, key="vote.solve"):
        pass
    with profiling.timed("runner.preprocess", device="cpu"):
        pass
    assert entered == ["slam.solve", "slam.vote.solve", "runner.preprocess"]
    assert [torch.device(d).type for d in synced] == ["cuda"]
    assert set(times) == {"detect.select", "solve", "vote.solve"}
    assert profiling.report()["slam.solve"]["count"] == 1
    profiling.reset()


def test_the_profiler_turns_tracing_on():
    assert not profiling.tracing()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.tracing()
    assert not profiling.tracing()


def test_no_span_of_a_drive_annotates_or_synchronises_with_tracing_off(messages,
                                                                       monkeypatch):
    calls = []

    def refuse(*a, **kw):
        calls.append(a)
        raise AssertionError("entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    drive = _chunked_drive(messages, monkeypatch)
    assert calls == [] and drive.slam.num_closures >= 1


@pytest.mark.parametrize("route", ["chunked", "message"])
def test_every_span_is_a_user_annotation_inside_its_parent(drives, route):
    _, _, chunked_spans, _, _, message_spans = drives
    spans, table = ((chunked_spans, CHUNKED_SPANS) if route == "chunked"
                    else (message_spans, MESSAGE_SPANS))
    assert set(table) <= set(spans), set(table) - set(spans)
    for child, parent in table.items():
        if parent is None:
            continue
        for a, b in spans[child]:
            assert any(pa <= a and b <= pb for pa, pb in spans[parent]), (child, parent)


def test_the_stream_kernel_span_is_a_user_annotation(tmp_path):
    spec, st, measC, odoms = stream_bench.build_inputs(3, num_beams=128, device="cpu")
    cacheB, poseB = sk.pack_stream_state(st.cacheT[None], st.pose[None])
    mC, oS = sk.pack_stream_measurements(measC[None], odoms[None])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, pB, pay = sk.track_streams_grid(spec, cacheB, poseB, mC, oS)
        fast_tracker.materialize(spec, st.scene.map(lambda x: x[None]), pay.movedim(2, 0),
                                 pB[:, 7])
    spans = _annotations(prof, tmp_path, "stream")
    assert len(spans["stream.track_streams_grid"]) == 1
    assert len(spans["tracker.materialize"]) == 1


def test_phase_keys_old_and_new(drives):
    off, on, _, msg_off, _, _ = drives
    for d in (off, on):
        assert set(d.slam.phase_times) == OLD_KEYS | NEW_KEYS
        assert all(v >= 0.0 for v in d.slam.phase_times.values())
        # the children lie inside their phase
        pt = d.slam.phase_times
        assert pt["detect.select"] + pt["detect.align"] + pt["detect.gate"] <= pt["detect"]
        assert pt["vote.solve"] <= pt["vote"]
    assert set(msg_off.slam.phase_times) >= {"track", "relocalize", "split", "detect",
                                             "vote", "vote.solve", "merge"}
    assert msg_off.runner.preprocess_time > 0.0
    assert off.runner.timing_summary()["phases"].keys() == OLD_KEYS | NEW_KEYS


def test_counters_count_the_drive(drives):
    off, on, _, _, _, _ = drives
    for d in (off, on):
        pairs, launches, solves, iterations = d.rises
        assert pairs == len(d.jobs) > 0
        assert launches == 0      # the plain version on the host launches nothing
        assert solves >= 1 and iterations >= solves
    assert off.rises == on.rises


def test_tracing_leaves_the_trajectory_and_the_graph_as_they_are(drives):
    off, on, _, msg_off, msg_on, _ = drives
    for a, b in ((off, on), (msg_off, msg_on)):
        assert a.slam.num_closures == b.slam.num_closures
        assert a.slam.relocalizations == b.slam.relocalizations
        assert a.slam.n_edges == b.slam.n_edges and a.slam.n_maps == b.slam.n_maps
        np.testing.assert_array_equal(a.slam.poses_np, b.slam.poses_np)
        for (i, j, m, w), (i2, j2, m2, w2) in zip(a.slam._edges_host, b.slam._edges_host):
            assert (i, j) == (i2, j2)
            np.testing.assert_array_equal(m, m2)
        ta = np.stack([p for _, p, _ in a.runner.trajectory])
        tb = np.stack([p for _, p, _ in b.runner.trajectory])
        np.testing.assert_array_equal(ta, tb)
    assert off.slam.num_closures >= 1 and msg_off.slam.num_closures >= 1
