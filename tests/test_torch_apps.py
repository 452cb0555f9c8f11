"""The port's message-driven entry points on the CPU: ``SlamRunner`` and
``apps/generic_bench_app`` over a 40-step synthetic log (``--device cpu``:
the plain PyTorch versions), the presets, and the options the port still
refuses. The log comes from the JAX package's ``bench/synthetic.simulate``
(numpy arrays from a seed), written as JSONL by the port's own writer."""

import json
import pathlib

import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.bench import synthetic
from srrg2_laser_slam_2d_tpu.utils import presets as jpresets
from srrg2_laser_slam_2d_tpu_torch.apps import generic_bench_app as app
from srrg2_laser_slam_2d_tpu_torch.io import logfile as tlogfile
from srrg2_laser_slam_2d_tpu_torch.io import tum
from srrg2_laser_slam_2d_tpu_torch.io.messages import (LaserMessage, OdometryMessage,
                                                       TransformEvent,
                                                       TransformEventsMessage)
from srrg2_laser_slam_2d_tpu_torch.io.sources import JsonlFileSource
from srrg2_laser_slam_2d_tpu_torch.models import runner as trunner
from srrg2_laser_slam_2d_tpu_torch.models.tracker import LaserTracker
from srrg2_laser_slam_2d_tpu_torch.utils import config as tconfig
from srrg2_laser_slam_2d_tpu_torch.utils import presets as tpresets

ROOT = pathlib.Path(__file__).resolve().parent.parent

@pytest.fixture(scope="module")
def log(tmp_path_factory):
    """A 40-step drive along a gentle arc at 256 beams: JSONL log with a TF
    message, odometry and laser messages, its ground truth as TUM, and a
    configuration file (the LASER_0 preset at 256 beams, 0.5 m local maps)."""
    import dataclasses

    ds = synthetic.simulate(synthetic.SyntheticConfig(
        steps=40, num_beams=256, max_variance=0.01, drift=(0.1, 0.0, 0.02), seed=3))
    c = ds.config
    sir = [float(v) for v in c.sensor_in_robot]
    msgs = [TransformEventsMessage(topic="/tf", timestamp=0.0, events=[
        TransformEvent(parent_frame="base_link", child_frame="laser", pose=sir)])]
    for k in range(len(ds.ranges)):
        msgs.append(OdometryMessage(topic="/odom", timestamp=0.1 * k,
                                    pose=ds.robot_poses[k].astype(np.float32)))
        msgs.append(LaserMessage(topic="/scan", timestamp=0.1 * k, ranges=ds.ranges[k],
                                 angle_min=c.angle_min, angle_max=c.angle_max,
                                 range_min=c.range_min, range_max=c.range_max))
    d = tmp_path_factory.mktemp("app")
    tlogfile.write_jsonl(str(d / "log.jsonl"), msgs)
    tum.write_tum(str(d / "gt.tum"), [0.1 * k for k in range(len(ds.ranges))], ds.robot_poses)
    slam = tpresets.laser0_slam(num_beams=256, scene_capacity=1024, device="cpu")
    mgr = tconfig.ConfigManager()
    # the chunked loop aligns closure candidates through the NN-ICP kernel only
    mgr.add(dataclasses.replace(
        slam, local_map_distance=0.5,
        detector=dataclasses.replace(slam.detector, backend="fused_nn")), "slam")
    mgr.add(dataclasses.replace(tpresets.laser0_preprocessor(), normal_window=8), "preprocessor")
    mgr.write(str(d / "config.json"))
    return d, ds


def test_generic_bench_app_writes_trajectory_and_artifact(log, capsys):
    d, ds = log
    rc = app.main(["-i", str(d / "log.jsonl"), "--gt", str(d / "gt.tum"),
                   "-c", str(d / "config.json"), "-o", str(d / "traj.tum"),
                   "-t", str(d / "timing.txt"), "--gate", "corridor",
                   "--json-out", str(d / "art.json"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "benchmark complete" in out and "mean_fps" in out, out
    n = len(ds.ranges)
    t, poses = tum.read_tum(str(d / "traj.tum"))
    assert len(t) == n and np.isfinite(poses).all()
    assert np.linalg.norm(poses[-1][:2]) > 2.0          # the robot drove some 4 m
    art = json.loads((d / "art.json").read_text())
    assert art["mode"] == "per_message" and art["frames"] == n
    assert art["device"] == "cpu" and art["card"] == "cpu" and "commit" in art
    # the app knows no sensor mounting, so it tracks the sensor; the ATE aligns
    # the two trajectories first. The circle-and-corner world does not pin the
    # heading: at 256 beams both packages drift 0.2 m over this drive
    assert art["gate_verdict"] == "PASS" and art["ate"]["rmse_translation"] < 0.4
    assert art["graph_variables"] >= 3 and art["graph_factors"] >= art["graph_variables"] - 1
    assert art["phases"]["track"] > 0 and art["preprocess_time_s"] > 0
    assert f"total_frames= {n}" in (d / "timing.txt").read_text()


def test_generic_bench_app_chunked_and_max_frames(log):
    d, _ = log
    args = app.parser().parse_args(["-i", str(d / "log.jsonl"), "-c", str(d / "config.json"),
                                    "--chunked", "16", "--max-frames", "24",
                                    "--device", "cpu"])
    rc, art, runner = app.run(args)
    assert rc == 0 and art["mode"] == "chunked[16]" and art["frames"] == 24
    assert len(runner.trajectory) == 24 and "ate" not in art


def test_unported_options_raise(log):
    """What the port still refuses: ``generic_bench_app --checkpoint`` with
    the chunked loop (checkpoints hold the per-message loop's state, as in
    the JAX package). ``slam_app --boss-config`` is ported: the LASER_0
    document runs the LASER_0 assembly (``tests/test_torch_boss_config.py``
    holds it to the JAX app). Resuming a ``SlamRunner`` from a checkpoint is
    ported."""
    from srrg2_laser_slam_2d_tpu_torch.apps import slam_app

    d, _ = log
    boss = str(ROOT / "tests" / "data" / "boss" / "laser0.boss.json")
    rc, runner = slam_app.run(slam_app.parser().parse_args(
        ["--boss-config", boss, "-i", str(d / "log.jsonl"), "--max-frames", "3",
         "--device", "cpu"]))
    assert rc == 0 and len(runner.trajectory) == 3
    assert runner.slam_config == tpresets.laser0_slam(device="cpu")
    assert app.main(["-i", str(d / "log.jsonl"), "--checkpoint", str(d / "c.npz"),
                     "--chunked", "16", "--device", "cpu"]) == -1
    assert not (d / "c.npz").exists()
    assert app.main(["--device", "cpu"]) == -1
    assert trunner.SlamRunner(scan_topics=["/a", "/b"], device="cpu").scan_topics == ["/a", "/b"]
    runner = trunner.SlamRunner(resume_checkpoint="c.npz", skip_frames=2, device="cpu")
    assert runner.resume_checkpoint == "c.npz" and runner.skip_frames == 2


def test_runner_takes_the_extrinsic_from_the_tf_tree_and_skips_frames(log, monkeypatch):
    d, ds = log
    cfg = tconfig.ConfigManager.read(str(d / "config.json"))
    runner = trunner.SlamRunner(slam_config=cfg.get_by_name("slam"),
                                preprocessor_config=cfg.get_by_name("preprocessor"),
                                sensor_frame="laser", base_frame="base_link",
                                skip_frames=2, device="cpu")
    n = runner.run(JsonlFileSource(str(d / "log.jsonl")), max_frames=6)
    assert n == 6 and len(runner.trajectory) == 6
    assert runner.trajectory[0][0] == pytest.approx(0.2)      # two frames skipped
    assert isinstance(runner.slam.tracker, LaserTracker)
    np.testing.assert_allclose(runner.slam.tracker.state.sensor_in_robot.numpy(),
                               np.array(ds.config.sensor_in_robot, np.float32))
    assert runner.timing_summary()["frames"] == 6
    assert trunner.SlamRunner(device="cpu").timing_summary() == {"frames": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trunner.SlamRunner()


def test_presets_match_the_jax_package(monkeypatch):
    """The LASER_0 assembly field by field (both packages write one file
    format), and the tracker default: the frame kernel on a card, the plain
    tracker on the CPU."""
    import dataclasses

    t = tpresets.laser0_slam(device="cpu")
    j = jpresets.laser0_slam(use_fast_tracker=False)
    assert t.use_fast_tracker is False
    assert tpresets.laser0_slam(device="cuda").use_fast_tracker is True
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tpresets.laser0_slam().use_fast_tracker is True

    def plain(x):
        if dataclasses.is_dataclass(x):
            return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
        return tuple(x) if isinstance(x, tuple) else x

    assert plain(t) == plain(j)
    assert plain(tpresets.laser0_preprocessor()) == plain(jpresets.laser0_preprocessor())
    assert tuple(tpresets.reference_projection(361)) == tuple(jpresets.reference_projection(361))
    assert plain(tpresets.laser0_tracking_aligner()) == plain(jpresets.laser0_tracking_aligner())
