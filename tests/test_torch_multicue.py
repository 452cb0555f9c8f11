"""The port's ``MultiCueTracker`` (two lasers and odometry) against the JAX
package's, on both aligner routes: ``icp.align_multi`` (the plain route)
and the multi-cue aligner kernel (``use_fused_aligner``; its plain version
here, the Pallas kernel in interpret mode on the JAX side). Mirrors
tests/test_multicue.py (ground truth, both cues contribute) and
tests/test_multicue_fused.py (the kernel route against the plain route,
iteration records).

Inputs: a front (0.2, 0, 0) and a rear (-0.2, 0, pi) laser of
``bench/synthetic.simulate`` (seed 0), 512 beams over +-0.4 pi tracked on a
512-beam canvas over +-pi.

Tolerances. One step from one carried-over state (``utils/interop``): the
final correspondence and inlier counts and the scene occupancy are EQUAL,
the counts of the iteration records within 2 (a beam at a depth or normal
gate while the estimates differ in the last digits); poses agree to 2e-4.
The world is a circle with a corner, so the rotation about the circle's
centre (and the y translation with it) is weakly constrained, and the
summation-order rounding of some 800 terms (XLA fuses multiply-adds,
PyTorch does not) moves the solution by up to 1.1e-4 rad (observed on this
drive; 1.4e-5 on the plain route, which matches half as many rows). Against the ground truth and between the routes the JAX tests'
own bounds hold: 0.05 m / 0.03 rad and 2e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.bench import synthetic
from srrg2_laser_slam_2d_tpu.models import tracker as jtracker
from srrg2_laser_slam_2d_tpu.models.preprocessor import (LaserModel, PreprocessorConfig,
                                                         ScanPreprocessor)
from srrg2_laser_slam_2d_tpu.ops import icp as jicp
from srrg2_laser_slam_2d_tpu.ops.projector import PolarProjection as JProjection
from srrg2_laser_slam_2d_tpu_torch.models import preprocessor as tpre
from srrg2_laser_slam_2d_tpu_torch.models import tracker as ttracker
from srrg2_laser_slam_2d_tpu_torch.ops import icp as ticp
from srrg2_laser_slam_2d_tpu_torch.ops import multicue_align_kernel as mak
from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection
from srrg2_laser_slam_2d_tpu_torch.utils import cloud as tcloud
from srrg2_laser_slam_2d_tpu_torch.utils import interop

FRONT = (0.2, 0.0, 0.0)
REAR = (-0.2, 0.0, np.pi)
EXTR = np.stack([FRONT, REAR]).astype(np.float32)
JP = JProjection.make(cols=512, angle_min=-np.pi, angle_max=np.pi, range_min=0.1,
                      range_max=30.0)
TP = PolarProjection(*JP)
STEP_TOL = 2e-4


def _datasets(steps: int):
    return [synthetic.simulate(synthetic.SyntheticConfig(steps=steps, num_beams=512,
                                                         sensor_in_robot=e))
            for e in (FRONT, REAR)]


def _model(ds):
    c = ds.config
    return c.num_beams, c.angle_min, c.angle_max, c.range_min, c.range_max


def _jax_measurements(dss):
    pre = ScanPreprocessor(PreprocessorConfig(voxelize_resolution=0.02, normal_window=8))
    pre.set_model(LaserModel(*_model(dss[0])))
    return [jax.tree.map(lambda a, b: jnp.stack([a, b]), pre.compute(dss[0].ranges[k]),
                         pre.compute(dss[1].ranges[k]))
            for k in range(len(dss[0].ranges))]


def _port_measurements(dss):
    pre = tpre.ScanPreprocessor(tpre.PreprocessorConfig(voxelize_resolution=0.02,
                                                        normal_window=8), device="cpu")
    pre.set_model(tpre.LaserModel(*_model(dss[0])))
    return [tcloud.stack([pre.compute(dss[0].ranges[k]), pre.compute(dss[1].ranges[k])])
            for k in range(len(dss[0].ranges))]


def _configs(fused: bool, iterations: int = 8):
    kw = dict(max_iterations=iterations, point_distance=0.5, normal_cos=0.8)
    return (jtracker.TrackerConfig(scene_capacity=4096, projection=JP,
                                   aligner=jicp.AlignerConfig(**kw), use_fused_aligner=fused),
            ttracker.TrackerConfig(scene_capacity=4096, projection=TP,
                                   aligner=ticp.AlignerConfig(**kw), use_fused_aligner=fused))


def _port_run(fused: bool, steps: int, iterations: int = 8):
    dss = _datasets(steps)
    trk = ttracker.MultiCueTracker(_configs(fused, iterations)[1], EXTR, device="cpu")
    poses, stats = [], None
    for k, meas in enumerate(_port_measurements(dss)):
        stats = trk.compute(meas, dss[0].robot_poses[k])
        poses.append(trk.robot_in_local_map.numpy().copy())
    return np.stack(poses), stats, dss[0].robot_poses, trk


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "kernel"])
def test_each_step_matches_jax_from_one_state(fused):
    dss = _datasets(5)
    jcfg, tcfg = _configs(fused)
    jtr = jtracker.MultiCueTracker(jcfg, EXTR)
    jmeas = _jax_measurements(dss)
    jtr.compute(jmeas[0], dss[0].robot_poses[0])
    before = mak.launches
    for k in range(1, len(jmeas)):
        ttr = interop.multicue_tracker_from_numpy(jtr, tcfg)
        ts = ttr.compute(interop.state_from_numpy(jmeas[k]), dss[0].robot_poses[k])
        js = jtr.compute(jmeas[k], dss[0].robot_poses[k])
        np.testing.assert_allclose(ttr.robot_in_local_map.numpy(),
                                   np.asarray(jtr.robot_in_local_map), atol=STEP_TOL)
        np.testing.assert_allclose(ts.estimate.numpy(), np.asarray(js.estimate), atol=STEP_TOL)
        assert int(ts.num_correspondences) == int(js.num_correspondences) > 300
        assert int(ts.num_inliers) == int(js.num_inliers)
        assert int(ts.scene_count) == int(js.scene_count)
        assert int(ts.status) == int(js.status) and int(ts.dropped_appends) == -1
        # iteration records: a beam at a gate may count on one side only
        count_diff = ts.iter_stats.numpy()[:, 1:3] - np.asarray(js.iter_stats)[:, 1:3]
        assert np.abs(count_diff).max() <= 2
        assert int(ts.iterations) == int(js.iterations)
    assert mak.launches == before       # CPU tensors: the plain version, no launch


def test_multicue_tracking_matches_ground_truth():
    poses, _, gt, trk = _port_run(False, 8, iterations=10)
    err = np.abs(poses - gt)
    assert err[:, :2].max() < 0.05, err
    assert err[:, 2].max() < 0.03, err
    assert trk.steps == 8


def test_both_cues_contribute_correspondences():
    """A single 0.8 pi cue occupies at most 205 beams of the 512-beam +-pi
    canvas; more than 250 correspondences need the second cue."""
    dss = _datasets(1)
    trk = ttracker.MultiCueTracker(_configs(False, 6)[1], EXTR, device="cpu")
    m0, m1 = _port_measurements(dss)
    assert trk.compute(m0, None) is None
    stats = trk.compute(m1, None)
    assert int(stats.num_correspondences) > 250, int(stats.num_correspondences)


def test_kernel_route_matches_plain_route_and_records_iterations():
    p_kernel, s_kernel, gt, _ = _port_run(True, 5)
    p_plain, _, _, _ = _port_run(False, 5)
    np.testing.assert_allclose(p_kernel, p_plain, atol=2e-3)
    err = np.abs(p_kernel - gt)
    assert err[:, :2].max() < 0.05 and err[:, 2].max() < 0.03, err
    it = s_kernel.iter_stats.numpy()
    assert it.shape == (8, 4) and np.isfinite(it).all()
    assert (it[:, 2] > 50).all(), it[:, 2]
    assert float(it[-1, 3]) < 0.01, it[-1]


def test_set_scene_reseed_and_capture():
    _, _, _, trk = _port_run(False, 2)
    scene = trk.capture_scene()
    trk.set_scene(scene, robot_in_local_map=[0.5, 0.0, 0.1])
    np.testing.assert_allclose(trk.robot_in_local_map.numpy(), [0.5, 0.0, 0.1])
    meas = _port_measurements(_datasets(1))[0]
    trk.reseed(meas, odom=np.zeros(3, np.float32))
    assert trk.robot_in_local_map.abs().sum() == 0
    assert int(trk.capture_scene().valid.sum()) == int(meas.valid.sum())
    assert trk.capture_scene().capacity == 4096


@pytest.mark.parametrize("capacity", [None, 5, 12])
def test_concat_matches_jax_and_stack_adds_the_cue_axis(capacity):
    from srrg2_laser_slam_2d_tpu.utils import cloud as jcloud

    rng = np.random.default_rng(1)
    a = [rng.normal(size=(6, 2)).astype(np.float32), rng.normal(size=(6, 2)).astype(np.float32),
         np.array([1, 0, 1, 1, 0, 1], bool)]
    b = [rng.normal(size=(4, 2)).astype(np.float32), rng.normal(size=(4, 2)).astype(np.float32),
         np.array([0, 1, 1, 0], bool)]
    j = jcloud.concat(jcloud.Cloud(*map(jnp.asarray, a)), jcloud.Cloud(*map(jnp.asarray, b)),
                      capacity)
    t = tcloud.concat(tcloud.Cloud(*map(torch.from_numpy, a)),
                      tcloud.Cloud(*map(torch.from_numpy, b)), capacity)
    for tf, jf in zip(t, j):
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    s = tcloud.stack([t, t])
    assert s.xy.shape == (2, t.capacity, 2) and torch.equal(s.valid[1], t.valid)
