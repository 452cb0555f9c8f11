"""The port's auxiliary modules against the JAX package: ``io/prefetch.py``
(order and the source's error on the consumer's side), ``apps/param_reference``
(the same text), ``apps/visual_tests`` and ``apps/corridor_report`` (the
same draw calls: the JAX package draws with matplotlib, the port with
``viz/canvas.py``, so parity is held on the primitives, not the pixels) and
``bench/corridor_e2e.run_native_baseline`` on a 200-frame slice of the
corridor log (where ``g++`` is at hand).

Tolerances: draw-call arrays within 1e-4 (the preprocessing's voxel means
differ by up to 1.5e-5 between the packages). The tracker stage tracks
seven scans without odometry into one scene: its trajectory drifts apart by
up to 1e-3 over the seven frames (a point that one merge puts on a
beam-bin edge is merged in one package and appended in the other, and the
next alignments see different scenes), so the trajectory is held to 5e-3
and the scenes to point counts within 2 % with 95 % of each scene's points
within 2 cm of a point of the other (measured: median 7e-4 m)."""

import os
import shutil
from unittest import mock

import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu_torch.apps import corridor_report as tcr
from srrg2_laser_slam_2d_tpu_torch.apps import param_reference as tpr
from srrg2_laser_slam_2d_tpu_torch.apps import visual_tests as tvt
from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e
from srrg2_laser_slam_2d_tpu_torch.bench import synthetic as tsyn
from srrg2_laser_slam_2d_tpu_torch.io import tum
from srrg2_laser_slam_2d_tpu_torch.io.prefetch import DevicePrefetcher



def _assert_scenes_close(a, b, tol=0.02, share=0.95):
    """Two scenes' valid points [N, 2], [M, 2]: counts within 2 %, and
    ``share`` of the points of each within ``tol`` of a point of the other."""
    assert abs(len(a) - len(b)) <= 0.02 * max(len(a), len(b)), (len(a), len(b))
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=2)
    assert (d.min(axis=1) <= tol).mean() >= share
    assert (d.min(axis=0) <= tol).mean() >= share


class Recorder:
    """A canvas that records every draw call with its arguments as host
    arrays (a cloud as its valid points); ``flush`` returns the path."""

    def __init__(self, *args, **kw):
        self.calls = []

    def flush(self, path=None):
        self.calls.append(("flush", [os.path.basename(path)]))
        return path

    def __getattr__(self, name):
        def record(*args, **kw):
            vals = []
            for a in list(args) + [kw[k] for k in sorted(kw)]:
                if hasattr(a, "xy") and hasattr(a, "valid"):
                    a = np.asarray(a.xy)[np.asarray(a.valid, bool)]
                vals.append(a if isinstance(a, str) else np.asarray(a, np.float64))
            self.calls.append((name, vals))
        return record


# ---------------------------------------------------------------- prefetch

def test_device_prefetcher_streams_in_order():
    items = [{"x": np.full((4,), k, np.float32), "pair": (np.arange(3), torch.ones(2) * k)}
             for k in range(10)]
    out = list(DevicePrefetcher(iter(items), depth=3, device="cpu"))
    assert len(out) == 10
    for k, item in enumerate(out):
        assert isinstance(item["x"], torch.Tensor) and item["x"].device.type == "cpu"
        np.testing.assert_allclose(item["x"].numpy(), k)
        np.testing.assert_array_equal(item["pair"][0].numpy(), np.arange(3))
        np.testing.assert_allclose(item["pair"][1].numpy(), k)


def test_device_prefetcher_raises_the_source_error_on_the_consumer_side():
    def bad():
        yield {"x": np.zeros(2, np.float32)}
        raise RuntimeError("boom")

    it = DevicePrefetcher(bad(), depth=1, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_device_prefetcher_matches_the_jax_one():
    """The JAX golden ``tests/test_multiprocess.py``: the same items, in
    order, from both prefetchers."""
    from srrg2_laser_slam_2d_tpu.io.prefetch import DevicePrefetcher as JPrefetcher

    items = [{"x": np.full((4,), k, np.float32)} for k in range(10)]
    for j, t in zip(JPrefetcher(iter(items), depth=3),
                    DevicePrefetcher(iter(items), depth=3, device="cpu"), strict=True):
        np.testing.assert_array_equal(t["x"].numpy(), np.asarray(j["x"]))


# --------------------------------------------------------- param_reference

def test_param_reference_renders_the_jax_text(tmp_path):
    from srrg2_laser_slam_2d_tpu.apps import param_reference as jpr
    from srrg2_laser_slam_2d_tpu.utils import config as jconfig
    from srrg2_laser_slam_2d_tpu_torch.utils import config as tconfig

    # every registry entry is in both packages
    assert set(tconfig.registry()) == set(jconfig.registry())
    assert tpr.render() == jpr.render()
    out = tmp_path / "docs" / "PARAMETERS.md"
    tpr.main(["-o", str(out)])
    assert out.read_text() == jpr.render()


# ------------------------------------------------------------ visual_tests

@pytest.fixture(scope="module")
def visual_setups():
    from srrg2_laser_slam_2d_tpu.apps import visual_tests as jvt

    return jvt, jvt._setup(), tvt._setup("cpu")


def _stage_calls(module, stage, setup, tmp_path):
    with mock.patch.object(module, "Canvas", Recorder):
        rec = []
        orig = Recorder.__init__

        def init(self, *a, **kw):
            orig(self, *a, **kw)
            rec.append(self)
        with mock.patch.object(Recorder, "__init__", init):
            module.STAGES[stage](str(tmp_path), *setup)
    (canvas,) = rec
    return canvas.calls


@pytest.mark.parametrize("stage", ["adaptor", "correspondences", "clipper", "merger",
                                   "aligner", "tracker"])
def test_visual_stage_draw_calls_match_jax(visual_setups, stage, tmp_path):
    jvt, jsetup, tsetup = visual_setups
    jcalls = _stage_calls(jvt, stage, jsetup, tmp_path)
    tcalls = _stage_calls(tvt, stage, tsetup, tmp_path)
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls]
    for (name, tv), (_, jv) in zip(tcalls, jcalls):
        assert len(tv) == len(jv)
        for t, j in zip(tv, jv):
            if isinstance(j, str):
                assert t == j
            elif stage == "tracker" and name == "put_cloud":
                _assert_scenes_close(t, j)
            elif stage == "tracker" and name == "put_trajectory":
                np.testing.assert_allclose(t, j, atol=5e-3)
            else:
                assert t.shape == j.shape, (name, t.shape, j.shape)
                np.testing.assert_allclose(t, j, atol=1e-4)


def test_visual_tests_main_writes_every_stage(tmp_path):
    outs = tvt.main(["--stage", "all", "--outdir", str(tmp_path), "--device", "cpu"])
    assert [os.path.basename(p) for p in outs] == [f"visual_test_{s}.png" for s in tvt.STAGES]
    for p in outs:
        assert os.path.getsize(p) > 1000


# --------------------------------------------------------- corridor_report

def test_corridor_report_draws_the_jax_figure(tmp_path, monkeypatch):
    """The JAX report's matplotlib calls (scatter of the walls, the two
    trajectories, the error curve) against the port's canvas calls on the
    same TUM files (300 frames of the drive, the estimate drifting)."""
    from srrg2_laser_slam_2d_tpu.apps import corridor_report as jcr
    from srrg2_laser_slam_2d_tpu_torch.models.loop_closure import relative_np

    gt = tsyn.corridor_trajectory(tsyn.CorridorConfig())[:300]
    est = gt.copy()
    est[:, :2] += np.linspace(0.0, 0.4, len(gt))[:, None]
    est_local = np.stack([relative_np(gt[0], p) for p in est])
    gt_path, est_path = str(tmp_path / "gt.tum"), str(tmp_path / "est.tum")
    ts = 0.1 * np.arange(len(gt))
    tum.write_tum(gt_path, ts, gt)
    tum.write_tum(est_path, ts, est_local)

    fig, ax1, ax2 = mock.MagicMock(), mock.MagicMock(), mock.MagicMock()
    import matplotlib.pyplot as plt

    monkeypatch.setattr(plt, "subplots", lambda *a, **kw: (fig, (ax1, ax2)))
    jcr.main(["--gt", gt_path, "--est", est_path, "-o", str(tmp_path / "j.png")])
    world, curve = Recorder(), Recorder()
    wxy, tgt, est_w, err = tcr.report_arrays(gt_path, est_path)
    tcr.draw(world, curve, wxy, tgt, est_w, err)
    assert [c[0] for c in world.calls] == ["set_point_size", "put_points", "put_trajectory",
                                           "put_trajectory"]
    (_, (pts, pcol)), (_, (g, gcol)), (_, (e, ecol)) = world.calls[1:]

    (sx, sy), skw = ax1.scatter.call_args
    np.testing.assert_array_equal(pts, np.stack([sx, sy], 1))
    assert pcol == skw["c"]
    (gx, gy), gkw = ax1.plot.call_args_list[0]
    (ex, ey), ekw = ax1.plot.call_args_list[1]
    np.testing.assert_allclose(g[:, :2], np.stack([gx, gy], 1), atol=1e-6)
    np.testing.assert_allclose(e[:, :2], np.stack([ex, ey], 1), atol=1e-6)
    assert (gcol, ecol) == (gkw["color"], ekw["color"])
    (jerr,), _ = ax2.plot.call_args
    curve_xy = curve.calls[-1][1][0]
    np.testing.assert_allclose(curve_xy[:, 1] * jerr.max(), jerr, atol=1e-5)
    np.testing.assert_allclose(err, jerr, atol=1e-6)
    assert curve_xy[0, 0] == 0.0 and curve_xy[-1, 0] == pytest.approx(tcr.CURVE_WIDTH)

    png = tcr.main(["--gt", gt_path, "--est", est_path, "-o", str(tmp_path / "t.png")])
    assert os.path.getsize(png) > 1000


# ------------------------------------------------------- native baseline

def test_run_native_baseline_on_a_corridor_slice(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: run_native_baseline returns an error record")
    with open(corridor_e2e.DATA) as f:
        head = [next(f) for _ in range(1 + 3 * 200)]
    data = tmp_path / "slice.jsonl"
    data.write_text("".join(head))
    res = corridor_e2e.run_native_baseline(str(data))
    assert "error" not in res, res
    assert res["frames"] == 200 and res["fps"] > 0
    assert np.isfinite(res["ate_rmse_translation_m"]) and res["ate_rmse_translation_m"] < 0.5
    assert res["gate_verdict"] == "PASS" and "tum" not in res
    exe = corridor_e2e.native_exe()
    assert exe.exists() and exe.name.startswith("baseline_slam-")
    assert str(exe.parent).endswith(os.path.join("build", "torch_native"))


def test_run_native_baseline_reports_a_failed_run(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    res = corridor_e2e.run_native_baseline(str(tmp_path / "missing.jsonl"))
    assert set(res) == {"error"} and "CalledProcessError" in res["error"]
