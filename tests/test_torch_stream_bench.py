"""The port's K-stream throughput path around the kernel
(srrg2_laser_slam_2d_tpu_torch/bench/synthetic.py, stream_bench.py,
headline.py, models/fast_tracker.py:track_sequence_fast) against the JAX
package on the CPU, from the same seeds.

Tolerances: the trajectory is float64 numpy on both sides (equal); ranges
and canvases come from the same float32 projection and preprocessing, where
XLA fuses multiply-adds, so depths and points agree to 1e-5 and normals
(the direction of a sliding-window covariance, which amplifies rounding) to
1e-4, the tolerance of tests/test_torch_preprocess.py; tracked poses and
scene points to 1e-4."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.bench import stream_bench as jsb
from srrg2_laser_slam_2d_tpu.bench import synthetic as jsyn
from srrg2_laser_slam_2d_tpu.models import fast_tracker as jft
from srrg2_laser_slam_2d_tpu.utils.cloud import Cloud as JCloud
from srrg2_laser_slam_2d_tpu_torch.bench import headline
from srrg2_laser_slam_2d_tpu_torch.bench import stream_bench as tsb
from srrg2_laser_slam_2d_tpu_torch.bench import synthetic as tsyn
from srrg2_laser_slam_2d_tpu_torch.models import fast_tracker as tft
from srrg2_laser_slam_2d_tpu_torch.ops import stream_kernel as tsk
from srrg2_laser_slam_2d_tpu_torch.utils.interop import state_from_numpy

FRAMES = 8
BEAMS = 181


@pytest.mark.parametrize("seed", [0, 17])
def test_simulate_matches_jax(seed):
    kw = dict(steps=12, num_beams=BEAMS, seed=seed, drift=(0.02, 0.0, 0.01))
    want = jsyn.simulate(jsyn.SyntheticConfig(**kw))
    got = tsyn.simulate(tsyn.SyntheticConfig(**kw), device="cpu")
    np.testing.assert_array_equal(got.robot_poses, want.robot_poses)
    np.testing.assert_array_equal(got.sensor_poses, want.sensor_poses)
    assert got.ranges.shape == (13, BEAMS) and got.ranges.dtype == np.float32
    assert (got.ranges > 0).mean() > 0.5
    np.testing.assert_allclose(got.ranges, np.asarray(want.ranges), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.scene.xy.numpy(), np.asarray(want.scene.xy))
    assert tuple(got.projection) == pytest.approx(tuple(want.projection))


@pytest.fixture(scope="module")
def inputs():
    jspec, jstate, jmeasC, jodoms = jsb.build_inputs(FRAMES, BEAMS)
    tspec, tstate, tmeasC, todoms = tsb.build_inputs(FRAMES, BEAMS, device="cpu")
    return (jspec, jstate, jmeasC, jodoms), (tspec, tstate, tmeasC, todoms)


def test_build_inputs_matches_jax(inputs):
    (jspec, jstate, jmeasC, jodoms), (tspec, tstate, tmeasC, todoms) = inputs
    for name in ("scene_capacity", "iterations", "window", "corr_refresh", "stream_gather",
                 "stream_band_shift", "odom_weight", "cols_padded", "merge_shift"):
        assert getattr(tspec, name) == getattr(jspec, name), name
    assert tuple(tspec.projection) == pytest.approx(tuple(jspec.projection))
    assert tmeasC.shape == (FRAMES - 1, 8, 256) and todoms.shape == (FRAMES - 1, 3)
    np.testing.assert_array_equal(todoms.numpy(), np.asarray(jodoms))
    tm, jm = tmeasC.numpy(), np.asarray(jmeasC)
    np.testing.assert_allclose(tm[:, 0:3], jm[:, 0:3], rtol=0, atol=1e-5)    # depth, point
    np.testing.assert_allclose(tm[:, 3:5], jm[:, 3:5], rtol=0, atol=1e-4)    # normal
    np.testing.assert_array_equal(tm[:, 5:8], jm[:, 5:8])                    # has, empty rows
    tc, jc = tstate.cacheT.numpy(), np.asarray(jstate.cacheT)
    np.testing.assert_allclose(tc[0:2], jc[0:2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc[2:4], jc[2:4], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tc[4:8], jc[4:8])                          # valid, rows
    np.testing.assert_allclose(tstate.pose.numpy(), np.asarray(jstate.pose), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tstate.scene.valid.numpy(), np.asarray(jstate.scene.valid))
    np.testing.assert_allclose(tstate.scene.xy.numpy(), np.asarray(jstate.scene.xy),
                               rtol=0, atol=1e-5)


def test_track_sequence_fast_matches_jax(inputs):
    """The single-stream bulk tracker measure_single times: one grid call
    and one materialization, against the JAX function in interpret mode."""
    (jspec, jstate, jmeasC, jodoms), (tspec, _, _, _) = inputs
    jmeasF = jmeasC.at[:, 6, 0:3].set(jodoms).at[:, 6, 3].set(1.0)[:4]
    jst, jstats = jft.track_sequence_fast(jspec, jstate, jmeasF)
    tst, tstats = tft.track_sequence_fast(tspec, state_from_numpy(jstate),
                                          state_from_numpy(np.asarray(jmeasF)))
    assert tstats.shape == (4, 7)
    np.testing.assert_allclose(tstats.numpy()[:, 0:3], np.asarray(jstats)[:, 0:3], atol=1e-4)
    np.testing.assert_array_equal(tstats.numpy()[:, 4:7], np.asarray(jstats)[:, 4:7])
    np.testing.assert_allclose(tst.pose.numpy(), np.asarray(jst.pose), atol=1e-4)
    np.testing.assert_array_equal(tst.scene.valid.numpy(), np.asarray(jst.scene.valid))
    np.testing.assert_allclose(tst.scene.xy.numpy(), np.asarray(jst.scene.xy), atol=1e-4)
    np.testing.assert_allclose(tst.cacheT.numpy()[0:4], np.asarray(jst.cacheT)[0:4], atol=1e-4)


def test_materialized_scenes_per_stream_match_jax():
    """K different streams through the port's K-stream path; each stream's
    scene, materialized in one batched call, against the JAX package's
    materialize on that stream's payloads."""
    K = 3
    spec, states, cacheB, poseB, measC, odomS = tsb.build_different_streams(
        FRAMES, K, BEAMS, device="cpu")
    _, pB, payB = tsk.track_streams_grid(spec, cacheB, poseB, measC, odomS)
    scene0 = tft.Cloud(*(torch.stack(f) for f in zip(*(st.scene for st in states))))
    scenes = tft.materialize(spec, scene0, payB.movedim(2, 0), pB[:, 7])
    assert scenes.xy.shape == (K, spec.scene_capacity, 2)
    assert not torch.equal(scenes.valid[0], scenes.valid[1])      # streams differ
    jspec = jsb.build_inputs(2, BEAMS)[0]
    for k in range(K):
        sc = states[k].scene
        want = jft.materialize(
            jspec, JCloud(jnp.asarray(sc.xy.numpy()), jnp.asarray(sc.normal.numpy()),
                          jnp.asarray(sc.valid.numpy())),
            jnp.asarray(payB[:, :, k].numpy()), jnp.asarray(pB[k, 7].numpy()))
        np.testing.assert_array_equal(scenes.valid[k].numpy(), np.asarray(want.valid))
        np.testing.assert_allclose(scenes.xy[k].numpy(), np.asarray(want.xy), rtol=0, atol=1e-6)
        np.testing.assert_allclose(scenes.normal[k].numpy(), np.asarray(want.normal),
                                   rtol=0, atol=1e-6)
    # and the port's single-stream path (track_sequence_fast) on each stream,
    # at the band and refresh the single-stream kernel has
    spec1 = dataclasses.replace(spec, corr_refresh=1, window=256)
    _, pB1, payB1 = tsk.track_streams_grid(spec1, cacheB, poseB, measC, odomS)
    scenes1 = tft.materialize(spec1, scene0, payB1.movedim(2, 0), pB1[:, 7])
    for k in range(K):
        measF = measC[:, :, k].clone()
        measF[:, 6, 0:4] = odomS[:, k, 0:4]
        st, _ = tft.track_sequence_fast(spec1, states[k], measF)
        np.testing.assert_array_equal(scenes1.valid[k].numpy(), st.scene.valid.numpy())
        np.testing.assert_allclose(scenes1.xy[k].numpy(), st.scene.xy.numpy(),
                                   rtol=0, atol=1e-4)


def test_measurements_return_their_keys(inputs):
    _, (tspec, tstate, tmeasC, todoms) = inputs
    single = tsb.measure_single(tspec, tstate, tmeasC, todoms, chain=2, reps=1)
    assert set(single) == {"frames", "chained_calls", "seconds", "scans_per_sec"}
    assert single["frames"] == 2 * (FRAMES - 1) and single["scans_per_sec"] > 0
    before = tsk.launches
    r = tsb.measure_streams(tspec, tstate, tmeasC, todoms, 2, chain=2, reps=1)
    assert tsk.launches == before      # CPU tensors never count as launches
    assert set(r) == {"k", "frames_per_stream", "chained_calls", "seconds",
                      "aggregate_scans_per_sec", "per_stream_scans_per_sec"}
    assert r["k"] == 2 and r["frames_per_stream"] == 2 * (FRAMES - 1)
    assert r["aggregate_scans_per_sec"] == pytest.approx(2 * r["per_stream_scans_per_sec"])
    parts = tsb.measure_streams(tspec, tstate, tmeasC, todoms, 2, chain=2, reps=1,
                                parts=True)["parts"]
    assert set(parts) == {"kernel_ms", "materialize_ms"} and parts["kernel_ms"] > 0


def test_stream_bench_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    out = tmp_path / "stream.json"
    monkeypatch.setattr("sys.argv", ["stream_bench", "--frames", "4", "--ks", "1,2",
                                     "--device", "cpu", "--out", str(out),
                                     "--corr-refresh", "1"])
    tsb.main()
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    saved = json.loads(out.read_text())
    assert printed == saved and saved["card"] == "cpu" and saved["num_beams"] == 721
    assert [s["k"] for s in saved["streams"]] == [1, 2]
    assert all(set(s["parts"]) == {"kernel_ms", "materialize_ms"} for s in saved["streams"])
    assert "single_stream" in saved and "backend" not in saved
    assert (saved["window"], saved["corr_refresh"], saved["stream_gather"]) == (128, 1, "onehot")


def test_headline_on_the_cpu_says_so():
    line = headline.headline(device="cpu", reps=1)
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "mode", "streams"]
    assert line["metric"] == "tracking_throughput" and line["unit"] == "scans/sec/chip"
    assert line["mode"] == "cpu_plain" and line["streams"] == headline.CPU_STREAMS
    assert line["value"] > 0
    assert line["vs_baseline"] is None or line["vs_baseline"] > 0
    json.dumps(line)


def test_headline_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        headline.headline()
    with pytest.raises(RuntimeError, match="CUDA"):
        tsb.build_inputs(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsyn.simulate()
