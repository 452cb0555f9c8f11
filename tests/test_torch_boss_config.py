"""The port's ``io/boss_config.py`` against the JAX package's on the CPU,
with the JAX translation as the golden, on the two BOSS documents under
``tests/data/boss/`` (written for these tests in the reference's format; they
are not the reference's shipped files):

- the parse: the same list of dicts, key for key; the same ``ValueError``
  for unbalanced braces and for a document without ``MultiGraphSLAM2D``;
- the translations: ``to_slam_config`` and ``to_preprocessor_config``
  written through each package's ``ConfigManager`` give EQUAL JSON files, on
  each document and on every document made from it by leaving one object
  out (its pointers then resolve to nothing, as ``{"#pointer": -1}`` does),
  which reaches each branch of the translator;
- the device rule: ``use_fused_aligner`` on a CUDA device for the MULTI
  assembly only (no kernel is launched: the rule reads the device's type);
- end to end: ``slam_app --boss-config`` with the LASER_0 document on the
  JAX generator's 16-scan log through both apps, per message and with
  ``--chunked 8``, the TUM trajectories within ``TRAJECTORY_TOL`` of
  ``tests/test_torch_slam_app.py`` (2.4e-2 m: both run the plain projective
  ICP tracker per message, or the frame kernel's plain version against the
  Pallas kernel in interpret mode in the chunked loop, on a 512-beam scan
  over +-0.4 pi tracked on a 721-beam canvas); the MULTI assembly through
  ``SlamRunner(scan_topics=...)`` in both packages on a 14-step dual drive
  at 512 beams, the graph counters EQUAL after every message and the
  trajectories within 1e-2 m / rad (``tests/test_torch_multicue_slam.py``);
  and what both apps do with the MULTI assembly fed one laser topic (an
  ``IndexError`` at the first tracked frame) and under ``--chunked`` (a
  ``ValueError``);
- the reference's own two files, once they are committed under
  ``configurations/`` (skipped while they are absent).
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.apps import slam_app as jslam_app
from srrg2_laser_slam_2d_tpu.apps import synthetic_scene_generator as jgen
from srrg2_laser_slam_2d_tpu.io import boss_config as jboss
from srrg2_laser_slam_2d_tpu.io import sources as jsources
from srrg2_laser_slam_2d_tpu.models import runner as jrunner
from srrg2_laser_slam_2d_tpu.utils import config as jconfig
from srrg2_laser_slam_2d_tpu.utils import presets as jpresets  # noqa: F401  (registers the JAX config classes)
from srrg2_laser_slam_2d_tpu_torch.apps import slam_app
from srrg2_laser_slam_2d_tpu_torch.apps import synthetic_scene_generator as tgen
from srrg2_laser_slam_2d_tpu_torch.bench import synthetic as tsynthetic
from srrg2_laser_slam_2d_tpu_torch.io import boss_config as tboss
from srrg2_laser_slam_2d_tpu_torch.io import logfile, sources, tum
from srrg2_laser_slam_2d_tpu_torch.models import runner as trunner
from srrg2_laser_slam_2d_tpu_torch.utils import config as tconfig
from srrg2_laser_slam_2d_tpu_torch.utils import presets as tpresets
from tests.test_torch_slam_app import TRAJECTORY_TOL

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "boss")
LASER0 = os.path.join(DATA, "laser0.boss.json")
MULTI = os.path.join(DATA, "multi.boss.json")
DOCUMENTS = {"laser0": LASER0, "multi": MULTI}
# the reference's shipped assemblies, once they are committed beside the
# repository's own configurations
REFERENCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "configurations", "stage_segway_double_config_{}.json")
MULTI_TOL = 1e-2
FRAMES = ["laser_frame_0", "laser_frame_1"]
TOPICS = ["/scan_0", "/scan_1"]


def _text(path):
    with open(path) as f:
        return f.read()


def _written(mgr_cls, cfg, tmp_path, name) -> dict:
    """``cfg`` written by a package's ``ConfigManager``, read back as JSON."""
    mgr = mgr_cls()
    mgr.add(cfg, "config")
    path = str(tmp_path / name)
    mgr.write(path)
    with open(path) as f:
        return json.load(f)


def _translations(objects, tmp_path):
    """Both packages' translations of one parsed document as written JSON,
    or the message of the ``ValueError`` that both raise."""
    out = {}
    for side, mod, mgr_cls, kw in (("jax", jboss, jconfig.ConfigManager, {}),
                                   ("port", tboss, tconfig.ConfigManager,
                                    {"device": "cpu"})):
        g = mod.BossGraph(copy.deepcopy(objects))
        try:
            slam = _written(mgr_cls, mod.to_slam_config(g, **kw), tmp_path, f"{side}_slam.json")
        except ValueError as e:
            slam = f"ValueError: {e}"
        pre = _written(mgr_cls, mod.to_preprocessor_config(g), tmp_path, f"{side}_pre.json")
        out[side] = (slam, pre)
    return out


# ---------------------------------------------------------------- the parse

@pytest.mark.parametrize("doc", sorted(DOCUMENTS))
def test_parse_gives_the_jax_parsers_objects(doc):
    text = _text(DOCUMENTS[doc])
    got, want = tboss.parse_boss(text), jboss.parse_boss(text)
    assert got == want
    assert [o["#class"] for o in got] == [o["#class"] for o in want]
    tg, jg = tboss.load(DOCUMENTS[doc]), jboss.load(DOCUMENTS[doc])
    assert tg.by_id == jg.by_id and tg.by_name == jg.by_name
    slam = tg.by_name["slam"]
    assert tg.deref(slam["tracker"])["#class"] == "MultiTracker2D"
    assert tg.deref({"#pointer": -1}) is None and tg.deref(3) == 3
    assert len(tg.find("MultiAligner2D")) == 2
    assert len(tg.find("CorrespondenceFinderProjective2f")) == (2 if doc == "laser0" else 3)
    lasers = [o["name"] for o in tg.find("TrackerSliceProcessorLaser2D")]
    assert lasers == (["tr_sl_scan_0"] if doc == "laser0" else ["tr_sl_scan_0", "tr_sl_scan_1"])


def test_parse_strips_comments_inside_bodies_and_refuses_what_the_jax_parser_refuses():
    text = _text(LASER0)
    assert "// iterations of the global optimization" in text
    gs = tboss.load(LASER0).by_name["global_solver"]
    assert gs["max_iterations"] == [20] and gs["#class"] == "Solver"
    unbalanced = '"MultiGraphSLAM2D" { "#id" : 1, "tracker" : { "#pointer" : 2 }'
    for mod in (tboss, jboss):
        with pytest.raises(ValueError, match="unbalanced braces after MultiGraphSLAM2D"):
            mod.parse_boss(unbalanced)
    no_slam = text.replace('"MultiGraphSLAM2D" {', '"SomethingElse2D" {')
    for mod in (tboss, jboss):
        with pytest.raises(ValueError, match="no MultiGraphSLAM2D in config"):
            mod.to_slam_config(mod.BossGraph(mod.parse_boss(no_slam)))


# ----------------------------------------------------------- the translations

@pytest.mark.parametrize("doc", sorted(DOCUMENTS))
def test_translations_equal_the_jax_translations(doc, tmp_path):
    objects = jboss.parse_boss(_text(DOCUMENTS[doc]))
    out = _translations(objects, tmp_path)
    assert out["port"] == out["jax"]
    slam, pre = out["port"]
    classes = {o["#class"] for o in slam["objects"]}
    assert {"GraphSLAMConfig", "TrackerConfig", "AlignerConfig", "PGOConfig",
            "LoopDetectorConfig"} <= classes
    assert pre["objects"][0]["#class"] == "PreprocessorConfig"
    # a solver's iterations as a number instead of a one-entry list
    for o in objects:
        if isinstance(o.get("max_iterations"), list):
            o["max_iterations"] = o["max_iterations"][0] + 1
    scalar = _translations(objects, tmp_path)
    assert scalar["port"] == scalar["jax"] and scalar["port"] != out["port"]


@pytest.mark.parametrize("doc", sorted(DOCUMENTS))
def test_translations_equal_the_jax_translations_with_each_object_left_out(doc, tmp_path):
    """Every document made by leaving one object out: the translator's
    branches for a missing splitter, tracker, aligner, slice, finder,
    projector, robustifier, merger, clipper, detector, selector, relocalize
    aligner, validator, relocalizer, solver, termination criteria,
    algorithm, policy, preprocessor and normal computator."""
    objects = jboss.parse_boss(_text(DOCUMENTS[doc]))
    raised = 0
    for i, left_out in enumerate(objects):
        out = _translations(objects[:i] + objects[i + 1:], tmp_path)
        assert out["port"] == out["jax"], (i, left_out["#class"])
        raised += isinstance(out["port"][0], str)
    assert raised == 1          # without MultiGraphSLAM2D both raise


def test_laser0_document_translates_to_the_laser0_preset():
    g = tboss.load(LASER0)
    assert tboss.to_slam_config(g, device="cpu") == tpresets.laser0_slam(device="cpu")
    pre = tboss.to_preprocessor_config(g)
    assert pre == dataclasses.replace(tpresets.laser0_preprocessor(),
                                      scan_topic="/diago_0/scan_0_0")


def test_multi_document_translation():
    cfg = tboss.to_slam_config(tboss.load(MULTI), device="cpu")
    assert cfg.cue_extrinsics == ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    assert cfg.global_solver.algorithm == "lm" and cfg.global_solver.chi_threshold == 1.0
    assert not cfg.use_fast_tracker and not cfg.tracker.use_fused_aligner
    # the relocalizer and the local-map selector are left out: their defaults
    laser0 = tboss.to_slam_config(tboss.load(LASER0), device="cpu")
    assert cfg.relocalizer == laser0.relocalizer
    assert cfg.detector == laser0.detector
    assert cfg.tracker.aligner == laser0.tracker.aligner


@pytest.mark.parametrize("device, multi, fused", [
    ("cpu", True, False), (torch.device("cuda"), True, True),
    ("cpu", False, False), (torch.device("cuda"), False, False)])
def test_fused_aligner_follows_the_device(device, multi, fused):
    g = tboss.load(MULTI if multi else LASER0)
    cfg = tboss.to_slam_config(g, device=device)
    assert cfg.tracker.use_fused_aligner is fused
    assert not cfg.use_fast_tracker
    assert (cfg.cue_extrinsics is not None) is multi


def test_fused_aligner_without_a_device_follows_the_card(monkeypatch):
    g = tboss.load(MULTI)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not tboss.to_slam_config(g).tracker.use_fused_aligner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tboss.to_slam_config(g).tracker.use_fused_aligner


# ------------------------------------------------------------- end to end

@pytest.fixture(scope="module")
def log(tmp_path_factory):
    d = tmp_path_factory.mktemp("boss_app")
    path = str(d / "log.jsonl")
    jgen.main(["-m", path, "--gt", str(d / "gt.tum"), "--steps", "15", "--beams", "512"])
    return path


@pytest.mark.parametrize("extra", [[], ["--chunked", "8"]], ids=["per_message", "chunked"])
def test_slam_app_boss_laser0_matches_the_jax_app(log, tmp_path, extra):
    jout, tout = str(tmp_path / "j.tum"), str(tmp_path / "t.tum")
    assert jslam_app.main(["--boss-config", LASER0, "-i", log, "-o", jout] + extra) == 0
    args = slam_app.parser().parse_args(["--boss-config", LASER0, "-i", log, "-o", tout,
                                         "--device", "cpu"] + extra)
    rc, runner = slam_app.run(args)
    assert rc == 0
    assert type(runner).__name__ == ("ChunkedSlamRunner" if extra else "SlamRunner")
    assert runner.slam_config.tracker.aligner.normal_cos == 0.9
    jt, jp = tum.read_tum(jout)
    tt, tp = tum.read_tum(tout)
    assert len(tt) == len(jt) == 16
    np.testing.assert_allclose(tt, jt)
    d = np.linalg.norm(tp[:, :2] - jp[:, :2], axis=1)
    print("boss slam_app trajectories apart by", d.max())
    assert d.max() < TRAJECTORY_TOL, d.max()
    assert np.isfinite(tp).all()


@pytest.fixture(scope="module")
def dual_log(tmp_path_factory):
    common = dict(steps=14, num_beams=512, max_variance=0.0, drift=(0.12, 0.0, 0.0), seed=2)
    dss = [tsynthetic.simulate(tsynthetic.SyntheticConfig(sensor_in_robot=e, **common),
                               device="cpu")
           for e in ((0.2, 0.0, 0.0), (-0.2, 0.0, np.pi))]
    path = str(tmp_path_factory.mktemp("boss_dual") / "dual.jsonl")
    logfile.write_jsonl(path, tgen.dual_dataset_to_messages(*dss, odom_noise=0.02, seed=4))
    return path


def test_multi_assembly_through_the_runner_matches_the_jax_runner(dual_log):
    tg, jg = tboss.load(MULTI), jboss.load(MULTI)
    kw = dict(scan_topics=TOPICS, sensor_frames=FRAMES, base_frame="base_frame")
    t = trunner.SlamRunner(slam_config=tboss.to_slam_config(tg, device="cpu"),
                           preprocessor_config=tboss.to_preprocessor_config(tg),
                           device="cpu", **kw)
    j = jrunner.SlamRunner(slam_config=jboss.to_slam_config(jg),
                           preprocessor_config=jboss.to_preprocessor_config(jg), **kw)
    topics = ["/tf", "/odom"] + TOPICS
    tsrc = sources.SynchronizedSource(sources.JsonlFileSource(dual_log), topics,
                                      time_interval=0.1)
    jsrc = jsources.SynchronizedSource(jsources.JsonlFileSource(dual_log), topics,
                                       time_interval=0.1)
    n = 0
    for tmsg, jmsg in zip(tsrc, jsrc, strict=True):
        assert t.put_message(tmsg) == j.put_message(jmsg)
        if t.slam is not None:
            n += 1
            assert (t.slam.num_variables(), t.slam.num_factors(), t.slam.num_closures) == \
                (j.slam.num_variables(), j.slam.num_factors(), j.slam.num_closures), n
    assert n == 15 and len(t.trajectory) == len(j.trajectory) == 15
    assert type(t.slam.tracker).__name__ == "MultiCueTracker"
    np.testing.assert_allclose(np.asarray(t.slam.cfg.cue_extrinsics),
                               np.asarray(j.slam.cfg.cue_extrinsics), atol=1e-6)
    np.testing.assert_allclose(np.asarray(t.slam.cfg.cue_extrinsics),
                               [(0.2, 0.0, 0.0), (-0.2, 0.0, np.pi)], atol=1e-6)
    tp = np.stack([p for _, p, _ in t.trajectory])
    jp = np.stack([np.asarray(p) for _, p, _ in j.trajectory])
    assert np.abs(tp - jp).max() < MULTI_TOL, np.abs(tp - jp).max(axis=0)
    assert t.slam.num_variables() >= 2


def test_multi_assembly_through_slam_app_fails_as_the_jax_app_does(dual_log):
    """Both apps feed a MULTI assembly one laser topic: the multi-cue
    tracker gets one cloud without a cue axis and fails at its first
    tracked frame with an ``IndexError``; ``--chunked`` refuses the
    assembly with a ``ValueError``."""
    argv = ["--boss-config", MULTI, "-i", dual_log]
    with pytest.raises(IndexError):
        jslam_app.main(argv)
    with pytest.raises(IndexError, match="cues' clouds stacked"):
        slam_app.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError, match="single-cue"):
        jslam_app.main(argv + ["--chunked", "8"])
    with pytest.raises(ValueError, match="single-cue"):
        slam_app.main(argv + ["--chunked", "8", "--device", "cpu"])


# ------------------------------------------------- the reference's own files

@pytest.mark.parametrize("which", ["LASER_0", "MULTI"])
def test_reference_files_translate_as_in_the_jax_package(which, tmp_path):
    path = REFERENCE.format(which)
    if not os.path.exists(path):
        pytest.skip(f"{path} is not in the repository")
    text = _text(path)
    assert tboss.parse_boss(text) == jboss.parse_boss(text)
    out = _translations(jboss.parse_boss(text), tmp_path)
    assert out["port"] == out["jax"]
