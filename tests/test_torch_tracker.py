"""The per-message tracker of the port against the JAX package: the plain
projective ICP (``ops/icp.py``), the clip and the projective mergers, one
``track_step`` per route from one carried-over state, and the
``LaserTracker`` wrapper. Inputs: ``bench/synthetic.simulate`` (seed 0) at
256 beams, a scene of 512 rows, 4 ICP iterations; the JAX side runs its
Pallas kernels in interpret mode.

Tolerances: poses and estimates agree to 1e-5, points to 1e-4 (XLA fuses
multiply-adds and sums in another order); counts and scene rows are equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.bench import pipeline, synthetic
from srrg2_laser_slam_2d_tpu.models import tracker as jtracker
from srrg2_laser_slam_2d_tpu.models.preprocessor import PreprocessorConfig
from srrg2_laser_slam_2d_tpu.ops import clip as jclip
from srrg2_laser_slam_2d_tpu.ops import icp as jicp
from srrg2_laser_slam_2d_tpu.ops import merge as jmerge
from srrg2_laser_slam_2d_tpu.ops.projector import PolarProjection as JProjection
from srrg2_laser_slam_2d_tpu.solver import pgo as jpgo
from srrg2_laser_slam_2d_tpu_torch.models import tracker as ttracker
from srrg2_laser_slam_2d_tpu_torch.ops import clip as tclip
from srrg2_laser_slam_2d_tpu_torch.ops import icp as ticp
from srrg2_laser_slam_2d_tpu_torch.ops import merge as tmerge
from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection
from srrg2_laser_slam_2d_tpu_torch.solver import pgo as tpgo
from srrg2_laser_slam_2d_tpu_torch.utils import cloud as tcloud
from srrg2_laser_slam_2d_tpu_torch.utils.interop import state_from_numpy
from srrg2_laser_slam_2d_tpu_torch.utils.status import Status, describe

BEAMS = 256
JP = JProjection.make(cols=BEAMS, angle_min=-np.pi, angle_max=np.pi, range_min=0.3,
                      range_max=20.0)
TP = PolarProjection(*JP)
ROUTES = {
    "C": {},
    "A": dict(use_fused_aligner=True, banded_aligner=True),
    "A-reuse": dict(use_fused_aligner=True, banded_aligner=True, reuse_clip_canvas=True),
    "A-lean": dict(use_fused_aligner=True, banded_aligner=True, reuse_clip_canvas=True,
                   lean_scene_ops=True),
    "B": dict(use_fused_aligner=True),
    "ball": dict(clipper="ball"),
}
# the canvas kernel's clip has one row per padded beam; 200 beams pad to 256
SCENE_OPS_ROUTES = {
    "B-scene-ops": dict(use_fused_aligner=True, use_fused_scene_ops=True),
    "B-scene-ops-reuse": dict(use_fused_aligner=True, use_fused_scene_ops=True,
                              reuse_clip_canvas=True),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return state_from_numpy(_np(tree))


@pytest.fixture(scope="module")
def scans():
    ds = synthetic.simulate(synthetic.SyntheticConfig(steps=4, num_beams=BEAMS))
    meas = pipeline.preprocess_batch(
        ds.projection, PreprocessorConfig(voxelize_resolution=0.02, normal_window=8),
        jnp.asarray(ds.ranges))
    return ds, [jax.tree.map(lambda x: x[k], meas) for k in range(len(ds.ranges))]


def _configs(proj_j, flags, iterations=4):
    al = dict(max_iterations=iterations, point_distance=0.5, normal_cos=0.8)
    jcfg = jtracker.TrackerConfig(scene_capacity=512, projection=proj_j,
                                  aligner=jicp.AlignerConfig(**al), **flags)
    tcfg = ttracker.TrackerConfig(scene_capacity=512, projection=PolarProjection(*proj_j),
                                  aligner=ticp.AlignerConfig(**al), **flags)
    return jcfg, tcfg


def _assert_cloud(t, j, atol=1e-4, flipped_rows=0):
    """Same valid rows, same points. ``flipped_rows``: how many rows may
    differ beyond ``atol``: a scene point whose transformed cell sits on a
    beam-bin edge takes the neighbouring beam under XLA's fused
    multiply-adds and is then merged with another measurement cell."""
    v = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), v)
    d = np.maximum(np.abs(t.xy.numpy() - np.asarray(j.xy)),
                   np.abs(t.normal.numpy() - np.asarray(j.normal)))[v].max(axis=1)
    assert (d > atol).sum() <= flipped_rows, (np.flatnonzero(d > atol), d.max())


# ------------------------------------------------------------------ ops/icp

def test_solve3_and_linearizations_match_jax(scans):
    _, meas = scans
    rng = np.random.default_rng(0)
    A = rng.normal(size=(3, 3)).astype(np.float32)
    H, b = A @ A.T + np.eye(3, dtype=np.float32), rng.normal(size=3).astype(np.float32)
    np.testing.assert_allclose(ticp.solve3(torch.from_numpy(H), torch.from_numpy(b)).numpy(),
                               np.asarray(jicp.solve3(jnp.asarray(H), jnp.asarray(b))), atol=1e-6)
    assert torch.equal(ticp.solve3(torch.zeros(3, 3), torch.ones(3)), torch.zeros(3))
    est, prior = np.array([0.05, -0.02, 0.03], np.float32), np.array([0.04, 0.0, 0.02], np.float32)
    for jv, tv in zip(jicp.odom_prior_linearize(jnp.asarray(est), jnp.asarray(prior), 2.0),
                      ticp.odom_prior_linearize(torch.from_numpy(est), torch.from_numpy(prior), 2.0)):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    from srrg2_laser_slam_2d_tpu.ops import projector as jproj
    from srrg2_laser_slam_2d_tpu_torch.ops import projector as tproj
    f, m = meas[1], meas[0]
    jcorr = jicp.find_projective(JP, jproj.project_local(JP, f), f, m, jnp.asarray(est), 0.5, 0.8)
    tf, tm = _port(f), _port(m)
    tcorr = ticp.find_projective(TP, tproj.project_local(TP, tf), tf, tm,
                                 torch.from_numpy(est), 0.5, 0.8)
    np.testing.assert_array_equal(tcorr.valid.numpy(), np.asarray(jcorr.valid))
    for inlier_only in (False, True):
        jl = jicp.p2p_linearize(jnp.asarray(est), f, m, jcorr, 0.05, inlier_only=inlier_only)
        tl = ticp.p2p_linearize(torch.from_numpy(est), tf, tm, tcorr, 0.05,
                                inlier_only=inlier_only)
        for jv, tv in zip(jl, tl):
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("extra", [
    {}, {"epsilon": 0.3}, {"enable_inlier_only_runs": True},
    {"keep_only_inlier_correspondences": True}, {"damping": 0.5, "odom_weight": 0.0},
    {"chi_threshold": 0.0, "min_num_correspondences": 20},
], ids=lambda e: "-".join(e) or "defaults")
def test_align_matches_jax(scans, extra):
    _, meas = scans
    kw = dict(max_iterations=6, point_distance=0.5, normal_cos=0.8, **extra)
    init = np.array([0.03, -0.02, 0.02], np.float32)
    j = jicp.align(jicp.AlignerConfig(**kw), JP, meas[1], meas[0], jnp.asarray(init),
                   odom_prior=jnp.asarray(init))
    t = ticp.align(ticp.AlignerConfig(**kw), TP, _port(meas[1]), _port(meas[0]),
                   torch.from_numpy(init), odom_prior=torch.from_numpy(init))
    np.testing.assert_allclose(t.estimate.numpy(), np.asarray(j.estimate), atol=1e-5)
    assert int(t.iterations) == int(j.iterations)
    assert int(t.num_correspondences) == int(j.num_correspondences) > 50
    assert int(t.num_inliers) == int(j.num_inliers)
    np.testing.assert_allclose(t.stats.numpy(), np.asarray(j.stats), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(float(t.chi), float(j.chi), rtol=1e-3)
    # the structures carry over field by field
    carried = state_from_numpy(_np(j))
    assert isinstance(carried, ticp.AlignResult) and carried.num_inliers.dtype == torch.int64


def test_align_over_a_batch_equals_one_by_one_and_other_finders_raise(scans):
    _, meas = scans
    cfg = ticp.AlignerConfig(max_iterations=5, odom_weight=0.0, epsilon=0.2)
    fixed = [_port(meas[1]), _port(meas[2])]
    moving = _port(meas[0])
    inits = torch.tensor([[0.03, -0.02, 0.02], [0.06, 0.0, 0.04]])
    batch = tcloud.Cloud(*(torch.stack(f) for f in zip(*fixed)))
    res = ticp.align(cfg, TP, batch, moving, inits)
    for k in range(2):
        one = ticp.align(cfg, TP, fixed[k], moving, inits[k])
        np.testing.assert_allclose(res.estimate[k].numpy(), one.estimate.numpy(), atol=1e-6)
        assert int(res.iterations[k]) == int(one.iterations)
        assert int(res.num_inliers[k]) == int(one.num_inliers)
    # the grid and brute-force finders run (held to the JAX package in
    # tests/test_torch_finders.py); a finder the reference does not have raises
    for finder in ("nn_grid", "bruteforce"):
        other = dataclasses.replace(cfg, finder=finder, finder_max_distance=0.5)
        res = ticp.align(other, TP, batch, moving, inits)
        one = ticp.align(other, TP, fixed[1], moving, inits[1])
        np.testing.assert_allclose(res.estimate[1].numpy(), one.estimate.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="kdtree"):
        ticp.align(dataclasses.replace(cfg, finder="kdtree"), TP, fixed[0], moving, inits[0])


# ------------------------------------------------------- clip and mergers

def test_clip_and_mergers_match_jax(scans):
    _, meas = scans
    jcfg, tcfg = _configs(JP, {})
    jst = jtracker.populate(jcfg, jtracker.init_state(jcfg), meas[0])
    tst = ttracker.populate(tcfg, ttracker.init_state(tcfg), _port(meas[0]))
    _assert_cloud(tst.scene, jst.scene, atol=1e-6)
    X = np.array([0.08, 0.01, 0.03], np.float32)
    S = np.array([0.1, 0.0, 0.0], np.float32)
    for res in (0.0, 0.05):
        _assert_cloud(tclip.clip_projective(TP, tst.scene, torch.from_numpy(X),
                                            torch.from_numpy(S), res),
                      jclip.clip_projective(JP, jst.scene, jnp.asarray(X), jnp.asarray(S), res),
                      atol=1e-5)
    _assert_cloud(tclip.clip_ball(tst.scene, torch.from_numpy(X), torch.from_numpy(S), 3.0),
                  jclip.clip_ball(jst.scene, jnp.asarray(X), jnp.asarray(S), 3.0), atol=1e-5)
    cam = np.array([0.17, 0.012, 0.03], np.float32)
    js, jcells, jrows, jdrop = jmerge.merge_projective(
        JP, jst.scene, meas[1], jnp.asarray(cam), return_canvas=True, return_dropped=True)
    ts, tcells, trows, tdrop = tmerge.merge_projective(
        TP, tst.scene, _port(meas[1]), torch.from_numpy(cam), return_canvas=True,
        return_dropped=True)
    _assert_cloud(ts, js)
    _assert_cloud(tcells, jcells)
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    assert int(tdrop) == int(jdrop) == 0 and int(ts.valid.sum()) > int(tst.scene.valid.sum())
    plain, d = tmerge.merge_projective(TP, tst.scene, _port(meas[1]), torch.from_numpy(cam),
                                       return_dropped=True)
    assert torch.equal(plain.xy, ts.xy) and int(d) == 0
    # the lean merge chained on that canvas, and a scene too full to take appends
    step = np.array([-0.09, 0.0, -0.01], np.float32)
    cam2 = np.array([0.26, 0.015, 0.04], np.float32)
    jl = jmerge.merge_projective_lean(JP, js, jcells, jrows, meas[2], jnp.asarray(step),
                                      jnp.asarray(cam2))
    tl = tmerge.merge_projective_lean(TP, ts, tcells, trows, _port(meas[2]),
                                      torch.from_numpy(step), torch.from_numpy(cam2))
    _assert_cloud(tl[0], jl[0])
    _assert_cloud(tl[1], jl[1])
    np.testing.assert_array_equal(tl[2].numpy(), np.asarray(jl[2]))
    live = int(jst.scene.valid.sum())
    full_j = jax.tree.map(lambda x: x[: live + 1], jst.scene)
    full_t = tst.scene.map(lambda x: x[: live + 1])
    _, jd = jmerge.merge_projective(JP, full_j, meas[1], jnp.asarray(cam), return_dropped=True)
    tfull, td = tmerge.merge_projective(TP, full_t, _port(meas[1]), torch.from_numpy(cam),
                                        return_dropped=True)
    assert int(td) == int(jd) > 0 and bool(tfull.valid.all())


# ------------------------------------------------------------- track_step

def _two_steps(jcfg, tcfg, ds, meas):
    """Both packages from one populated state: a first step, the JAX state
    after it carried into the port, then the compared second step (which
    takes its clip from the cache where the route keeps one)."""
    sir = np.array(ds.config.sensor_in_robot, np.float32)
    jst = jtracker.populate(jcfg, jtracker.init_state(jcfg, sir), meas[0])
    jst = jst._replace(last_odom=jnp.asarray(ds.robot_poses[0], jnp.float32),
                       has_odom=jnp.asarray(True))
    jst, _ = jtracker.track_step_impl(jcfg, jst, meas[1],
                                      jnp.asarray(ds.robot_poses[1], jnp.float32),
                                      jnp.asarray(True))
    tst = _port(jst)
    assert isinstance(tst, ttracker.TrackerState) and tst.clip_cache_rows.dtype == torch.int64
    cached = bool(jcfg.reuse_clip_canvas)
    odom = ds.robot_poses[2].astype(np.float32)
    jn, jstats = jtracker.track_step_impl(jcfg, jst, meas[2], jnp.asarray(odom),
                                          jnp.asarray(True), use_clip_cache=cached)
    tn, tstats = ttracker.track_step(tcfg, tst, _port(meas[2]), torch.from_numpy(odom),
                                     torch.tensor(True), use_clip_cache=cached)
    return jn, jstats, tn, tstats


def _assert_step(jn, jstats, tn, tstats, pose_tol=1e-5, chi_rtol=1e-3):
    np.testing.assert_allclose(tn.robot_in_local_map.numpy(), np.asarray(jn.robot_in_local_map),
                               atol=pose_tol)
    np.testing.assert_allclose(tstats.estimate.numpy(), np.asarray(jstats.estimate),
                               atol=pose_tol)
    _assert_cloud(tn.scene, jn.scene, flipped_rows=2)
    assert int(tstats.num_correspondences) == int(jstats.num_correspondences) > 50
    assert int(tstats.num_inliers) == int(jstats.num_inliers)
    assert int(tstats.status) == int(jstats.status) == Status.SUCCESS
    assert int(tstats.scene_count) == int(jstats.scene_count)
    assert int(tstats.dropped_appends) == int(jstats.dropped_appends)
    np.testing.assert_allclose(tstats.iter_stats.numpy(), np.asarray(jstats.iter_stats),
                               rtol=chi_rtol, atol=1e-6)
    _assert_cloud(tn.clip_cache, jn.clip_cache, flipped_rows=2)
    np.testing.assert_array_equal(tn.clip_cache_rows.numpy(), np.asarray(jn.clip_cache_rows))
    np.testing.assert_allclose(tn.last_odom.numpy(), np.asarray(jn.last_odom))
    carried = state_from_numpy(_np(jstats))
    assert isinstance(carried, ttracker.TrackStats) and carried.scene_full.dtype == torch.bool


@pytest.mark.parametrize("route", list(ROUTES))
def test_track_step_matches_jax_on_each_route(scans, route):
    ds, meas = scans
    jcfg, tcfg = _configs(JP, ROUTES[route])
    _assert_step(*_two_steps(jcfg, tcfg, ds, meas))


@pytest.mark.parametrize("route", list(SCENE_OPS_ROUTES))
def test_track_step_matches_jax_with_the_scene_canvas_kernel(route):
    ds = synthetic.simulate(synthetic.SyntheticConfig(steps=4, num_beams=200))
    jp = JProjection.make(cols=200, angle_min=-np.pi, angle_max=np.pi, range_min=0.3,
                          range_max=20.0)
    meas = pipeline.preprocess_batch(
        ds.projection, PreprocessorConfig(voxelize_resolution=0.02, normal_window=8),
        jnp.asarray(ds.ranges))
    meas = [jax.tree.map(lambda x: x[k], meas) for k in range(3)]
    jcfg, tcfg = _configs(jp, SCENE_OPS_ROUTES[route])
    # the compared step clips the scene through the canvas kernel in each
    # package: one scene point on a beam-bin edge lands on the neighbouring
    # beam under XLA's fused multiply-adds, and with 80 correspondences at
    # 200 beams that one cell moves chi by 0.1 % and the estimate by 5e-5
    _assert_step(*_two_steps(jcfg, tcfg, ds, meas), pose_tol=1e-4, chi_rtol=5e-3)


# ------------------------------------------------------------ LaserTracker

def test_laser_tracker_follows_the_jax_wrapper(scans):
    ds, meas = scans
    jcfg, tcfg = _configs(JP, ROUTES["A-reuse"])
    sir = np.array(ds.config.sensor_in_robot, np.float32)
    jt = jtracker.LaserTracker(jcfg, sir)
    tt = ttracker.LaserTracker(tcfg, sir, device="cpu")
    for k in range(4):
        jt.compute(meas[k], ds.robot_poses[k])
        tt.compute(_port(meas[k]), ds.robot_poses[k])
    # three steps, each run on its own package's state: the bin-edge flips of
    # single scene rows add up to 1e-4 in the pose
    np.testing.assert_allclose(tt.robot_in_local_map.numpy(), np.asarray(jt.robot_in_local_map),
                               atol=2e-4)
    assert tt.steps == 3 and tt.cached_clips == 2
    _assert_cloud(tt.capture_scene(), jt.capture_scene(), atol=5e-4, flipped_rows=6)
    # a scene handed over is taken as it is and never written into
    scene = tt.capture_scene()
    before = scene.xy.clone()
    tt.set_scene(scene, robot_in_local_map=np.array([0.1, 0.0, 0.0], np.float32))
    tt.compute(_port(meas[3]), ds.robot_poses[3])
    assert torch.equal(scene.xy, before) and tt.cached_clips == 2
    tt.reseed(_port(meas[3]), ds.robot_poses[3])
    jt.reseed(meas[3], ds.robot_poses[3])
    assert torch.equal(tt.robot_in_local_map, torch.zeros(3))
    _assert_cloud(tt.capture_scene(), jt.capture_scene(), atol=1e-6)


def test_scene_grows_at_the_watermark_and_set_scene_keeps_capacity_in_step(scans):
    ds, meas = scans
    _, tcfg = _configs(JP, {})
    live = int(meas[0].valid.sum())
    small = dataclasses.replace(tcfg, scene_capacity=live + 8, grow_watermark=0.9)
    tt = ttracker.LaserTracker(small, device="cpu")
    tt.compute(_port(meas[0]), ds.robot_poses[0])
    stats = tt.compute(_port(meas[1]), ds.robot_poses[1])
    assert tt.cfg.scene_capacity == 2 * (live + 8) == tt.capture_scene().capacity
    assert int(stats.scene_count) == int(tt.capture_scene().valid.sum())
    fixed = ttracker.LaserTracker(dataclasses.replace(small, auto_grow_scene=False), device="cpu")
    fixed.compute(_port(meas[0]), ds.robot_poses[0])
    fixed.compute(_port(meas[1]), ds.robot_poses[1])
    assert fixed.cfg.scene_capacity == live + 8
    fixed.set_scene(tt.capture_scene())
    assert fixed.cfg.scene_capacity == tt.cfg.scene_capacity
    assert describe(Status.SUCCESS) == "SUCCESS" and describe(7) == "UNKNOWN(7)"


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttracker.LaserTracker()
    assert ttracker.LaserTracker(device="cpu").device == torch.device("cpu")


# ------------------------------------------------------------------- pgo

def test_trim_and_untrim_match_jax():
    rng = np.random.default_rng(1)
    poses = rng.normal(size=(64, 3)).astype(np.float32)
    jg = jpgo.empty_graph(64, 128)._replace(poses=jnp.asarray(poses))
    tg = tpgo.empty_graph(64, 128)._replace(poses=torch.from_numpy(poses))
    jt, jvc, jec = jpgo.trim(jg, 20, 37)
    tt, tvc, tec = tpgo.trim(tg, 20, 37)
    assert (tvc, tec) == (jvc, jec) == (32, 64)
    assert tt.var_capacity == 32 and tt.edge_capacity == 64
    solved = tt._replace(poses=tt.poses + 1.0)
    back = tpgo.untrim_poses(tg, solved)
    jback = jpgo.untrim_poses(jg, jt._replace(poses=jt.poses + 1.0))
    np.testing.assert_allclose(back.poses.numpy(), np.asarray(jback.poses))
    assert torch.equal(tg.poses, torch.from_numpy(poses))        # the full graph is not written
    assert tpgo.trim(tg, 500, 500)[1:] == (64, 128)
