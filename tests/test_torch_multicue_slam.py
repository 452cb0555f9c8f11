"""The MULTI slice as a whole: ``GraphSLAM2D`` with ``cue_extrinsics`` (two
lasers and odometry through ``MultiCueTracker``) against the JAX package's
over the 14-step straight drive of tests/test_multicue_slam.py; the port's
dual-laser log generator against the JAX generator; ``SlamRunner`` with
``scan_topics`` and the extrinsics taken from the TF tree, dual against an
occluded single laser as in tests/test_multicue_slam.py; the
``multi_slam`` preset; and the plain versions of the two probe kernels (the
shift z-buffer against the JAX test-local Pallas kernel in interpret mode
and the projector's z-buffer, the banded gather against numpy).

Tolerances: variables and factors EQUAL after every message; trajectories
within 1e-2 m / rad (the graphs are built from the trackers' poses, which
agree to 2e-4 per step, tests/test_torch_multicue.py); generated messages
EQUAL in type, topic, frame, sequence number, timestamp and pose, ranges
within 1e-5 (two projector implementations); the probe's depths within
1e-6, its winners and validity EQUAL; the gather within 1e-5 of numpy's
``take_along_axis`` times the pass count (ten float32 additions against one
product)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.apps import synthetic_scene_generator as jgen
from srrg2_laser_slam_2d_tpu.bench import synthetic
from srrg2_laser_slam_2d_tpu.models import loop_closure as jlc
from srrg2_laser_slam_2d_tpu.models import slam as jslam_mod
from srrg2_laser_slam_2d_tpu.models import tracker as jtracker
from srrg2_laser_slam_2d_tpu.models.preprocessor import (LaserModel, PreprocessorConfig,
                                                         ScanPreprocessor)
from srrg2_laser_slam_2d_tpu.ops import icp as jicp
from srrg2_laser_slam_2d_tpu.ops.projector import PolarProjection as JProjection
from srrg2_laser_slam_2d_tpu_torch.apps import synthetic_scene_generator as tgen
from srrg2_laser_slam_2d_tpu_torch.bench import exp_gather
from srrg2_laser_slam_2d_tpu_torch.bench import suite as tsuite
from srrg2_laser_slam_2d_tpu_torch.bench import synthetic as tsynthetic
from srrg2_laser_slam_2d_tpu_torch.io import logfile
from srrg2_laser_slam_2d_tpu_torch.io.sources import JsonlFileSource, SynchronizedSource
from srrg2_laser_slam_2d_tpu_torch.models import loop_closure as tlc
from srrg2_laser_slam_2d_tpu_torch.models import preprocessor as tpre
from srrg2_laser_slam_2d_tpu_torch.models import slam as tslam_mod
from srrg2_laser_slam_2d_tpu_torch.models import tracker as ttracker
from srrg2_laser_slam_2d_tpu_torch.models.runner import SlamRunner
from srrg2_laser_slam_2d_tpu_torch.ops import beam_zbuffer_kernel as bzk
from srrg2_laser_slam_2d_tpu_torch.ops import icp as ticp
from srrg2_laser_slam_2d_tpu_torch.ops import projector as tprojector
from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection
from srrg2_laser_slam_2d_tpu_torch.utils import cloud as tcloud
from srrg2_laser_slam_2d_tpu_torch.utils import presets as tpresets

FRONT = (0.2, 0.0, 0.0)
REAR = (-0.2, 0.0, np.pi)
JP = JProjection.make(cols=512, angle_min=-np.pi, angle_max=np.pi, range_min=0.1,
                      range_max=30.0)
TP = PolarProjection(*JP)


def _slam_configs(**over):
    """The JAX and the port's GraphSLAMConfig of tests/test_multicue_slam.py."""
    kw = dict(local_map_distance=0.5, var_capacity=32, edge_capacity=64,
              enable_loop_closure=False, enable_relocalizer=False,
              cue_extrinsics=(FRONT, REAR))
    kw.update(over)
    j = jslam_mod.GraphSLAMConfig(
        tracker=jtracker.TrackerConfig(scene_capacity=2048, projection=JP,
                                       aligner=jicp.AlignerConfig(max_iterations=8)),
        validator=jlc.ValidatorConfig(enabled=False), **kw)
    t = tslam_mod.GraphSLAMConfig(
        tracker=ttracker.TrackerConfig(scene_capacity=2048, projection=TP,
                                       aligner=ticp.AlignerConfig(max_iterations=8)),
        validator=tlc.ValidatorConfig(enabled=False), **kw)
    return j, t


def test_multicue_graph_slam_matches_jax_after_every_message():
    common = dict(steps=14, num_beams=512, max_variance=0.0, drift=(0.11, 0.0, 0.0))
    dss = [synthetic.simulate(synthetic.SyntheticConfig(sensor_in_robot=e, **common))
           for e in (FRONT, REAR)]
    c = dss[0].config
    model = (c.num_beams, c.angle_min, c.angle_max, c.range_min, c.range_max)
    jpre = ScanPreprocessor(PreprocessorConfig(voxelize_resolution=0.02, normal_window=8))
    jpre.set_model(LaserModel(*model))
    tpre_ = tpre.ScanPreprocessor(tpre.PreprocessorConfig(voxelize_resolution=0.02,
                                                          normal_window=8), device="cpu")
    tpre_.set_model(tpre.LaserModel(*model))
    jcfg, tcfg = _slam_configs()
    jslam, tslam = jslam_mod.GraphSLAM2D(jcfg), tslam_mod.GraphSLAM2D(tcfg, device="cpu")
    assert isinstance(tslam.tracker, ttracker.MultiCueTracker)
    worlds = []
    for k in range(len(dss[0].ranges)):
        jslam.process(jax.tree.map(lambda a, b: jnp.stack([a, b]),
                                   jpre.compute(dss[0].ranges[k]),
                                   jpre.compute(dss[1].ranges[k])), dss[0].robot_poses[k])
        tslam.process(tcloud.stack([tpre_.compute(dss[0].ranges[k]),
                                    tpre_.compute(dss[1].ranges[k])]), dss[0].robot_poses[k])
        assert (tslam.num_variables(), tslam.num_factors()) == \
            (jslam.num_variables(), jslam.num_factors()), k
        worlds.append((tslam.robot_in_world(), np.asarray(jslam.robot_in_world())))
    assert (tslam.num_variables(), tslam.num_factors()) == (3, 2)
    d = np.abs(np.stack([t for t, _ in worlds]) - np.stack([j for _, j in worlds]))
    assert d.max() < 1e-2, d.max(axis=0)
    np.testing.assert_allclose(tslam.poses_np, np.asarray(jslam.poses_np)[:3], atol=1e-2)
    err = np.abs(tslam.robot_in_world() - dss[0].robot_poses[-1])
    assert err[:2].max() < 0.06, err
    assert tslam.tracker.steps == len(dss[0].ranges) - 1   # a split reseeds after its step


def _dual(simulate, steps, **kw):
    common = dict(steps=steps, num_beams=512, max_variance=0.0, drift=(0.12, 0.0, 0.0),
                  seed=2)
    common.update(kw)
    mod = synthetic if simulate is synthetic.simulate else tsynthetic
    return [simulate(mod.SyntheticConfig(sensor_in_robot=e, **common)) for e in (FRONT, REAR)]


def _port_simulate(cfg):
    return tsynthetic.simulate(cfg, device="cpu")


def _assert_same_messages(tm, jm):
    assert len(tm) == len(jm)
    for t, j in zip(tm, jm):
        assert type(t).__name__ == type(j).__name__
        for name in ("topic", "frame_id", "seq", "timestamp"):
            assert getattr(t, name) == getattr(j, name), (name, t, j)
        if hasattr(j, "ranges"):
            np.testing.assert_allclose(t.ranges, j.ranges, atol=1e-5)
            assert (t.angle_min, t.angle_max, t.angle_increment) == \
                (j.angle_min, j.angle_max, j.angle_increment)
        if hasattr(j, "pose"):
            np.testing.assert_array_equal(np.asarray(t.pose), np.asarray(j.pose))
        if hasattr(j, "events"):
            for te, je in zip(t.events, j.events):
                assert (te.child_frame, te.parent_frame, te.timestamp) == \
                    (je.child_frame, je.parent_frame, je.timestamp)
                np.testing.assert_array_equal(te.pose, je.pose)


def test_generator_gives_the_jax_generators_messages():
    jds = _dual(synthetic.simulate, 6)
    tds = _dual(_port_simulate, 6)
    for a, b in zip(jds, tds):
        np.testing.assert_array_equal(a.robot_poses, b.robot_poses)
    kw = dict(odom_noise=0.05, occlude=(0, 2, 4), seed=4)
    _assert_same_messages(tgen.dual_dataset_to_messages(*tds, **kw),
                          jgen.dual_dataset_to_messages(*jds, **kw))
    odom = jgen.noisy_odometry(jds[0].robot_poses, 0.02, 0.005, 7)
    np.testing.assert_array_equal(tgen.noisy_odometry(tds[0].robot_poses, 0.02, 0.005, 7),
                                  odom)
    tm, jm = (tgen.dataset_to_messages(tds[0], odom), jgen.dataset_to_messages(jds[0], odom))
    np.testing.assert_allclose(tm[0].points, jm[0].points, atol=1e-6)
    _assert_same_messages(tm[1:], jm[1:])


def _ate(runner, gt_t, gt_poses) -> float:
    s = tsuite.BenchmarkSuite()
    s.set_ground_truth(np.asarray(gt_t, np.float64), np.stack(gt_poses))
    for ts, pose, _ in runner.trajectory:
        s.set_pose_estimate(pose, ts)
    return s.compute(align=True)["rmse_translation"]


def test_dual_runner_with_tf_extrinsics_beats_occluded_single(tmp_path):
    steps = 30
    dss = _dual(_port_simulate, steps)
    msgs = tgen.dual_dataset_to_messages(*dss, odom_noise=0.05, occlude=(0, 6, 26), seed=4)
    path = str(tmp_path / "dual.jsonl")
    logfile.write_jsonl(path, msgs)
    _, base = _slam_configs(local_map_distance=0.6, cue_extrinsics=None)
    pcfg = tpre.PreprocessorConfig(voxelize_resolution=0.02, normal_window=8)

    def run(**kw):
        runner = SlamRunner(slam_config=base, preprocessor_config=pcfg,
                            base_frame="base_frame", device="cpu", **kw)
        topics = ["/tf", "/odom"] + (kw.get("scan_topics") or [kw.get("scan_topic")])
        n = runner.run(SynchronizedSource(JsonlFileSource(path), topics, time_interval=0.1))
        assert n == steps + 1
        return runner

    dual = run(scan_topics=["/scan_0", "/scan_1"],
               sensor_frames=["laser_frame_0", "laser_frame_1"])
    got = np.asarray(dual.slam.cfg.cue_extrinsics)
    np.testing.assert_allclose(got, np.stack([FRONT, REAR]), atol=1e-6)
    assert isinstance(dual.slam.tracker, ttracker.MultiCueTracker)
    assert dual.preprocess_time > 0
    single = run(scan_topic="/scan_0", sensor_frame="laser_frame_0")
    gt_t = [m.timestamp for m in msgs if getattr(m, "topic", "") == "/scan_0"]
    ate_dual = _ate(dual, gt_t, dss[0].robot_poses)
    ate_single = _ate(single, gt_t, dss[0].robot_poses)
    assert ate_dual <= ate_single, (ate_dual, ate_single)
    assert ate_dual < 0.1, ate_dual


def test_runner_skips_packs_without_every_laser_and_needs_the_tf(tmp_path):
    dss = _dual(_port_simulate, 2)
    msgs = tgen.dual_dataset_to_messages(*dss)
    _, base = _slam_configs(cue_extrinsics=None)
    runner = SlamRunner(slam_config=base, scan_topics=["/scan_0", "/scan_1"],
                        sensor_frames=["laser_frame_0", "nowhere"], base_frame="base_frame",
                        device="cpu")
    lasers = [m for m in msgs if getattr(m, "topic", "") == "/scan_0"]
    assert runner.put_message(lasers[0]) is False        # no /scan_1 in it: skipped
    from srrg2_laser_slam_2d_tpu_torch.io.messages import MessagePack
    pack = MessagePack(messages=msgs[:4])
    with pytest.raises(RuntimeError, match="no TF nowhere"):
        runner.put_message(pack)


def test_multi_slam_preset_builds_the_multicue_tracker():
    cfg = tpresets.multi_slam(device="cpu")
    assert cfg.cue_extrinsics == ((0.0, 0.0, 0.0), (0.0, 0.0, float(np.pi)))
    assert not cfg.tracker.use_fused_aligner and not cfg.use_fast_tracker
    assert tpresets.multi_slam(device="cuda").tracker.use_fused_aligner
    assert tpresets.multi_slam(use_fused_aligner=True, device="cpu").tracker.use_fused_aligner
    slam = tslam_mod.GraphSLAM2D(tpresets.multi_slam(256, 1024, device="cpu"), device="cpu")
    assert isinstance(slam.tracker, ttracker.MultiCueTracker)
    assert slam.tracker.cfg.scene_capacity == 1024
    # the same assembly as the JAX preset, field by field
    from srrg2_laser_slam_2d_tpu.utils import presets as jpresets

    j = jpresets.multi_slam(use_fused_aligner=False)
    assert dataclasses.asdict(cfg.tracker.aligner) == dataclasses.asdict(j.tracker.aligner)
    assert cfg.cue_extrinsics == j.cue_extrinsics
    assert cfg.local_map_distance == j.local_map_distance


def _jax_shift_zbuffer(geoT, proj):
    """The Pallas kernel of tests/test_fast_tracker.py:62-81 (interpret mode)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from srrg2_laser_slam_2d_tpu.ops import _beam_kernels as jbk

    B = geoT.shape[1]

    def kernel(geoT_ref, out_ref):
        g = geoT_ref[:]
        mov = (g[0:1], g[1:2], g[2:3], g[3:4], g[4:5])
        f = jbk.moving_fields(mov, jnp.zeros(3), proj)
        vals = jnp.concatenate([f["px"], f["py"], g[5:6], jnp.zeros((5, B), jnp.float32)], 0)
        smin, svals, s_ok = jbk.beam_zbuffer_by_shifts(vals, f["d"], f["col_i"], f["okp"], 32)
        out_ref[:] = jnp.concatenate([smin, svals[0:3], s_ok.astype(jnp.float32),
                                      jnp.zeros((3, B), jnp.float32)], 0)

    return pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((8, B), jnp.float32),
                          in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
                          out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
                          interpret=True)(jnp.asarray(geoT))


def _probe_cells(beams: int = 256):
    """The shift z-buffer probe's projection and input: a synthetic scan's
    cells, one per beam, moved by a small pose."""
    ds = tsynthetic.simulate(tsynthetic.SyntheticConfig(steps=1, num_beams=beams), "cpu")
    proj = PolarProjection.make(cols=beams, angle_min=-np.pi, angle_max=np.pi,
                                range_min=0.3, range_max=20.0)
    pre = tpre.ScanPreprocessor(tpre.PreprocessorConfig(voxelize_resolution=0.02,
                                                        normal_window=8), device="cpu")
    c = ds.config
    pre.set_model(tpre.LaserModel(beams, c.angle_min, c.angle_max, c.range_min, c.range_max))
    m0 = pre.compute(ds.ranges[0])
    canvas = tprojector.project_local(proj, m0)
    idx = canvas.idx.clamp(min=0)
    cells = tcloud.Cloud(m0.xy[idx], m0.normal[idx], canvas.valid)
    return proj, tcloud.transform(cells, torch.tensor([0.03, -0.02, 0.05]))


def test_shift_zbuffer_probe_matches_pallas_probe_and_projector():
    beams = 256
    proj, moved = _probe_cells(beams)
    geoT = bzk.pack_cells(moved, proj)
    before = bzk.launches
    out = bzk.beam_zbuffer_probe(proj, geoT).numpy()
    assert bzk.launches == before
    j = np.asarray(_jax_shift_zbuffer(geoT.numpy(), JProjection(*proj)))
    np.testing.assert_array_equal(out[4], j[4])
    np.testing.assert_array_equal(out[3], j[3])      # the winner's home row
    np.testing.assert_allclose(out[:3], j[:3], atol=1e-6)
    # and the projector's z-buffer of the same cells, as the JAX test holds it
    ref = tprojector.project_local(proj, moved)
    s_ok = out[4, :beams] > 0
    assert (s_ok == ref.valid.numpy()).mean() > 0.995
    both = s_ok & ref.valid.numpy()
    assert both.sum() > 80          # a 0.8 pi scan covers 102 of the 256 beams
    assert np.abs(out[0, :beams][both] - ref.depth.numpy()[both]).max() < 1e-5


@pytest.mark.parametrize("seed", [0, 1])
def test_shift_zbuffer_probe_ties_match_pallas_probe(seed):
    """Cells with forced two- and three-way depth ties at beams' minima
    (``with_tied_rows``: copies of a beam's closest cell written over the
    lanes that follow it): the ties reach the minima, and the plain
    ``beam_zbuffer_by_shifts`` picks the JAX one's winners (the highest
    tied lane) there."""
    proj, moved = _probe_cells()
    B = bzk.cols_padded(proj)
    tied = tsynthetic.with_tied_rows(moved, seed, True, view=(proj, torch.zeros(3), B))
    geoT = bzk.pack_cells(tied, proj)
    assert bzk.tie_counts(proj, bzk.pack_cells(moved, proj)) == {1}
    assert {2, 3} <= bzk.tie_counts(proj, geoT)
    out = bzk.beam_zbuffer_probe(proj, geoT).numpy()
    j = np.asarray(_jax_shift_zbuffer(geoT.numpy(), JProjection(*proj)))
    np.testing.assert_array_equal(out[4], j[4])
    np.testing.assert_array_equal(out[3], j[3])      # the winner's home row
    np.testing.assert_allclose(out[:3], j[:3], atol=1e-6)
    # a beam won by a tie goes to the highest of the tied lanes
    g = geoT.numpy()
    copies = [r for r in range(1, B) if g[4, r] > 0 and g[0, r] == g[0, r - 1]
              and g[1, r] == g[1, r - 1] and g[4, r - 1] > 0]
    won = set(out[3][out[4] > 0].astype(int).tolist())
    assert len(copies) >= 10 and all((r - 1) not in won for r in copies)


@pytest.mark.parametrize("K", [2, 8])
def test_gather_probe_plain_matches_numpy(K):
    canvas, idx = exp_gather.make_inputs(K, "cpu", lanes=256, shift=16)
    before = exp_gather.launches
    out = exp_gather.gather_probe(canvas, idx, 10, "roll", shift=16)
    assert exp_gather.launches == before
    ref = exp_gather.reference(canvas.numpy(), idx.numpy(), 10)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    assert int((idx - torch.arange(256)).abs().max()) <= 16
    with pytest.raises(ValueError):
        exp_gather.gather_probe(canvas, idx, 10, "take2d")
