"""The port's ``apps/slam_app.py`` against the JAX package's on the CPU:
the JAX generator's 16-scan log (as ``tests/test_apps.py`` makes it)
through both apps, the default configuration that ``-j`` writes read back
by both packages, the parameter sheets (``describe``) and ``create``, the
draw calls of both packages' runners on a recording canvas, and the PNG
the port's canvas writes.

Tolerances. The two trajectories are held to 2.4e-2 m: both apps run the
LASER_0 preset (721-beam canvas over +-pi) on a 512-beam scan over
+-0.4 pi, the plain projective-ICP tracker on both sides; single steps
agree to 1e-5 off the beam grid (``tests/test_torch_tracker.py``), and over
16 frames the merge decisions on bin edges add up (observed 1.2e-5 m). The
draw calls carry the same arrays within 1e-4 (poses, reference frames,
trajectory, edges); a scene's point count agrees within 2 %, and 98 % of
its points have a point of the other package's scene within 1e-4: a scene
point on a beam-bin edge may be merged with a measurement in one package
and appended in the other (observed 6 of 513 points up to 0.017 m apart).
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.apps import slam_app as jslam_app
from srrg2_laser_slam_2d_tpu.apps import synthetic_scene_generator
from srrg2_laser_slam_2d_tpu.io import sources as jsources
from srrg2_laser_slam_2d_tpu.utils import config as jconfig
from srrg2_laser_slam_2d_tpu.utils import presets as jpresets
from srrg2_laser_slam_2d_tpu_torch.apps import slam_app
from srrg2_laser_slam_2d_tpu_torch.io import sources, tum
from srrg2_laser_slam_2d_tpu_torch.utils import config as tconfig
from srrg2_laser_slam_2d_tpu_torch.utils import presets as tpresets
from srrg2_laser_slam_2d_tpu_torch.viz.canvas import Canvas

TRAJECTORY_TOL = 2.4e-2
DRAW_TOL = 1e-4
SCENE_AGREE = 0.98


def assert_scene_points_agree(a, b):
    """Two scenes' valid points [N, 2], [M, 2]: counts within 2 %, and 98 %
    of the points of each with a point of the other within ``DRAW_TOL``."""
    assert abs(len(a) - len(b)) <= 0.02 * max(len(a), len(b)), (len(a), len(b))
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=2)
    assert (d.min(axis=1) <= DRAW_TOL).mean() >= SCENE_AGREE
    assert (d.min(axis=0) <= DRAW_TOL).mean() >= SCENE_AGREE


@pytest.fixture(scope="module")
def log_and_gt(tmp_path_factory):
    d = tmp_path_factory.mktemp("slam_app")
    log, gt = str(d / "log.jsonl"), str(d / "gt.tum")
    synthetic_scene_generator.main(["-m", log, "--gt", gt, "--steps", "15", "--beams", "512"])
    return log, gt


def _png_chunks(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    chunks, pos = [], 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        chunks.append((kind, body))
        pos += 12 + n
    return chunks


def _png_image(path):
    """The [h, w, 3] pixels of an RGB PNG without filters, its structure
    checked on the way: IHDR first, IDAT inflating to h * (1 + 3 w) bytes,
    IEND last."""
    chunks = _png_chunks(path)
    assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    w, h, depth, color, _, _, _ = struct.unpack(">IIBBBBB", chunks[0][1])
    assert (depth, color) == (8, 2)
    raw = zlib.decompress(chunks[1][1])
    assert len(raw) == h * (1 + 3 * w)
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_slam_app_matches_the_jax_slam_app(log_and_gt, tmp_path):
    log, gt = log_and_gt
    jout, tout, png = (str(tmp_path / n) for n in ("j.tum", "t.tum", "map.png"))
    assert jslam_app.main(["-c", "/nonexistent.json", "-i", log, "-o", jout]) == 0
    assert slam_app.main(["-c", "/nonexistent.json", "-i", log, "-o", tout, "--draw", png,
                          "--device", "cpu"]) == 0
    jt, jp = tum.read_tum(jout)
    tt, tp = tum.read_tum(tout)
    gt_t, gt_p = tum.read_tum(gt)
    assert len(tt) == len(gt_t) == 16
    np.testing.assert_allclose(tt, jt)
    d = np.linalg.norm(tp[:, :2] - jp[:, :2], axis=1)
    print("slam_app trajectories apart by", d.max())
    assert d.max() < TRAJECTORY_TOL, d.max()
    # the JAX app's own bound against the ground truth
    assert np.linalg.norm(tp[:, :2] - gt_p[:, :2], axis=1).max() < 0.1
    img = _png_image(png)
    assert img.shape == (960, 960, 3)
    assert (img != 255).any(axis=2).sum() > 100         # something was drawn


def test_chunked_slam_app_and_what_it_refuses(log_and_gt, tmp_path, monkeypatch):
    log, _ = log_and_gt
    out = str(tmp_path / "c.tum")
    args = slam_app.parser().parse_args(["-c", "/nonexistent.json", "-i", log, "-o", out,
                                         "--chunked", "8", "--device", "cpu"])
    rc, runner = slam_app.run(args)
    assert rc == 0 and type(runner).__name__ == "ChunkedSlamRunner"
    t, p = tum.read_tum(out)
    assert len(t) == 16 and np.isfinite(p).all()
    # the chunked loop is single-cue: it refuses a MULTI assembly, as the JAX app does
    multi = os.path.join(os.path.dirname(__file__), "data", "boss", "multi.boss.json")
    with pytest.raises(ValueError, match="single-cue"):
        slam_app.main(["--boss-config", multi, "-i", log, "--chunked", "8", "--device", "cpu"])
    assert slam_app.main(["-c", "/nonexistent.json", "--device", "cpu"]) == -1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        slam_app.main(["-c", "/nonexistent.json", "-i", log])


def _plain(x):
    """A configuration as nested plain values (the two packages' classes
    differ, their fields do not)."""
    import dataclasses

    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return tuple(_plain(v) for v in x) if isinstance(x, tuple) else x


def _named(mgr):
    return {name: _plain(mgr.get_by_name(name)) for name in mgr._names}


def test_generated_configuration_reads_back_in_both_packages(tmp_path):
    tpath, jpath = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    assert slam_app.main(["-j", "-c", tpath, "--device", "cpu"]) == 0
    assert jslam_app.main(["-j", "-c", jpath]) == 0
    tdoc, jdoc = json.load(open(tpath)), json.load(open(jpath))
    assert tdoc == jdoc
    assert {e["#class"] for e in tdoc["objects"]} >= {"GraphSLAMConfig", "TrackerConfig"}
    want = _named(jpresets.default_config_manager())
    assert set(want) == {"slam", "tracker", "aligner", "loop_detector", "closure_validator",
                         "relocalizer", "global_solver", "preprocessor"}
    for path in (tpath, jpath):
        assert _named(jconfig.ConfigManager.read(path)) == want
        back = tconfig.ConfigManager.read(path)
        assert _named(back) == want
        assert back.get_by_name("slam") == tpresets.laser0_slam(device="cpu")
        assert back.get_by_name("tracker") is back.get_by_name("slam").tracker
    # on a card the assembly tracks through the frame kernel
    card = tpresets.default_config_manager(device="cuda").get_by_name("slam")
    assert card.use_fast_tracker and not back.get_by_name("slam").use_fast_tracker


def test_describe_and_create_match_the_jax_package():
    names = sorted(tconfig.registry())
    assert names == sorted(jconfig.registry())
    for name in names:
        if name == "PolarProjection":      # a NamedTuple: no parameter sheet in either
            continue
        # the annotation's text names the class, with the module alias its
        # file imports it under ("icp.AlignerConfig" or "AlignerConfig")
        t, j = tconfig.describe(name), jconfig.describe(name)
        assert [(p["name"], p["type"].split(".")[-1], p["doc"]) for p in t] == \
            [(p["name"], p["type"].split(".")[-1], p["doc"]) for p in j], name
        assert [_plain(p["default"]) for p in t] == [_plain(p["default"]) for p in j], name
    by_name = {p["name"]: p for p in tconfig.describe("AlignerConfig")}
    assert by_name["max_iterations"]["default"] == 10 and "Cauchy" in by_name["chi_threshold"]["doc"]
    mgr, jmgr = tconfig.ConfigManager(), jconfig.ConfigManager()
    made = mgr.create("AlignerConfig", "custom", max_iterations=42, point_distance=2.5)
    jmade = jmgr.create("AlignerConfig", "custom", max_iterations=42, point_distance=2.5)
    assert mgr.get_by_name("custom") is made and _plain(made) == _plain(jmade)
    assert type(made).__module__.startswith("srrg2_laser_slam_2d_tpu_torch")


class RecordingCanvas:
    """Records every draw call with its arguments as host arrays (a cloud
    as its valid points)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args, **kw):
            vals = []
            for a in list(args) + [kw[k] for k in sorted(kw)]:
                if hasattr(a, "xy") and hasattr(a, "valid"):
                    xy, valid = np.asarray(a.xy), np.asarray(a.valid, bool)
                    a = xy[valid]
                vals.append(a if isinstance(a, str) else np.asarray(a, np.float64))
            self.calls.append((name, vals))
        return record


def _draw_calls(runner):
    canvas = RecordingCanvas()
    runner.draw(canvas)
    return canvas.calls


def test_draw_calls_match_the_jax_runner(log_and_gt):
    """Both packages' ``SlamRunner.draw`` on a recording canvas after the
    same run: the same calls in the same order, arrays within 1e-4."""
    import argparse

    log, _ = log_and_gt
    args = argparse.Namespace(config="/nonexistent.json", generate_config=False,
                              boss_config=None, scan_topic=None, odom_topic="/odom",
                              sensor_frame="scan", base_frame="base_frame", chunked=0,
                              device="cpu")
    jrun = jslam_app.build_runner(args)
    jrun.run(jsources.JsonlFileSource(log))
    trun = slam_app.build_runner(args, torch.device("cpu"))
    trun.run(sources.JsonlFileSource(log))
    jcalls, tcalls = _draw_calls(jrun), _draw_calls(trun)
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls]
    assert {c[0] for c in tcalls} >= {"push_matrix", "mult_matrix", "put_reference_system",
                                      "put_cloud", "pop_matrix", "put_trajectory",
                                      "put_segments"}
    for (name, tv), (_, jv) in zip(tcalls, jcalls):
        assert len(tv) == len(jv), name
        for a, b in zip(tv, jv):
            if isinstance(b, str):
                assert a == b, name
                continue
            if name == "put_cloud":
                assert_scene_points_agree(a, b)
            else:
                np.testing.assert_allclose(a, b, atol=DRAW_TOL, err_msg=name)


def test_canvas_renders_every_primitive_to_a_png(tmp_path):
    canvas = Canvas("test", figsize=(2, 1))
    canvas.set_point_size(9.0)
    canvas.push_color()
    canvas.set_color("#ff0000")
    canvas.put_points(np.array([[0.0, 0.0], [1.0, 1.0], [5.0, 5.0]]), valid=[True, True, False])
    canvas.pop_attribute()
    canvas.push_matrix()
    canvas.mult_matrix([1.0, 0.0, np.pi / 2])
    canvas.put_reference_system(0.5)
    canvas.pop_matrix()
    canvas.put_segments([[0.0, 1.0]], [[1.0, 0.0]], color="gray")
    canvas.put_trajectory(np.array([[0.0, 0.0, 0.0], [0.5, 0.2, 0.0], [1.0, 0.0, 0.0]]))
    path = canvas.flush(str(tmp_path / "c.png"))
    img = _png_image(path)
    assert img.shape == (120, 240, 3)
    colors = {tuple(c) for c in img.reshape(-1, 3)}
    assert {(255, 0, 0), (0, 128, 0), (128, 128, 128), (0, 0, 0), (255, 255, 255)} <= colors
    assert canvas._color == "#1f77b4" and canvas._point_size == 9.0
    canvas.close()
    assert _png_image(canvas.flush(str(tmp_path / "empty.png"))).min() == 255
