"""Kernel 6 (the multi-cue aligner) and ``icp.align_multi`` of the port
against the JAX package: the plain version of ``fused_projective_align_multi``
against the Pallas kernel in interpret mode, the port's ``align_multi``
against the JAX ``align_multi``, constructed cases (a cue without a valid
point, the pi-rotated rear cue alone, damping, a correspondence minimum that
blocks every update, odometry weight 0 and 1) and ``remap_sums9`` against the
matrix form A^T H A.

Inputs: a front (0.2, 0, 0) and a rear (-0.2, 0, pi) laser of
``bench/synthetic.simulate`` (seed 0) at 256 beams, preprocessed by the JAX
package; the moving cloud is the concatenation of the two per-cue clips of a
scene seeded from frame 0 with ``populate_multi``; the fixed clouds are frame
1's measurements; 6 Gauss-Newton iterations.

Tolerances: estimates agree to 1e-5 (XLA fuses multiply-adds and sums in
another order), the counts are equal, chi and the iteration records to rtol
1e-4."""

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
from srrg2_laser_slam_2d_tpu.ops import pallas_multicue_align as jma
from srrg2_laser_slam_2d_tpu.ops.projector import PolarProjection as JProjection
from srrg2_laser_slam_2d_tpu.utils import cloud as jcloud
from srrg2_laser_slam_2d_tpu.utils import geometry as jgeo
from srrg2_laser_slam_2d_tpu_torch.ops import icp as ticp
from srrg2_laser_slam_2d_tpu_torch.ops import multicue_align_kernel as mak
from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection
from srrg2_laser_slam_2d_tpu_torch.utils.cloud import Cloud

BEAMS = 256
FRONT = (0.2, 0.0, 0.0)
REAR = (-0.2, 0.0, np.pi)
JP = JProjection.make(cols=BEAMS, angle_min=-np.pi, angle_max=np.pi, range_min=0.3,
                      range_max=20.0)
TP = PolarProjection(*JP)
KW = dict(iterations=6, point_distance=0.5, normal_cos=0.8, chi_threshold=0.05,
          min_inliers=10, min_corr=1, odom_weight=1.0, damping=0.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tc(c):
    return Cloud(_t(c.xy), _t(c.normal), _t(c.valid))


@pytest.fixture(scope="module")
def inputs():
    """(fixed [C, N] clouds of frame 1, extrinsics [C, 3], moving cloud,
    initial guess) as numpy-backed JAX arrays."""
    common = dict(steps=3, num_beams=BEAMS, max_variance=0.05, drift=(0.05, 0.0, 0.02))
    dss = [synthetic.simulate(synthetic.SyntheticConfig(sensor_in_robot=e, **common))
           for e in (FRONT, REAR)]
    pcfg = PreprocessorConfig(voxelize_resolution=0.02, normal_window=8)
    meas = [pipeline.preprocess_batch(ds.projection, pcfg, jnp.asarray(ds.ranges))
            for ds in dss]
    stacked = jax.tree.map(lambda a, b: jnp.stack([a, b], axis=1), *meas)     # [T, C, N]
    extr = jnp.asarray(np.stack([FRONT, REAR]).astype(np.float32))
    cfg = jtracker.TrackerConfig(scene_capacity=1024, projection=JP)
    st = jtracker.populate_multi(cfg, jtracker.init_state(cfg),
                                 jax.tree.map(lambda x: x[0], stacked), extr)
    clips = [jclip.clip_projective(JP, st.scene, st.robot_in_local_map, extr[c], 0.0)
             for c in range(2)]
    moving = jcloud.concat(clips[0], clips[1])
    poses = dss[0].robot_poses
    T0 = jgeo.inverse(jgeo.relative(jnp.asarray(poses[0]), jnp.asarray(poses[1])))
    return jax.tree.map(lambda x: x[1], stacked), extr, moving, np.asarray(T0)


def _kernel_args(fixed, extr, moving, T0, to):
    return (to(fixed.xy), to(fixed.normal), to(fixed.valid), to(extr), to(moving.xy),
            to(moving.normal), to(moving.valid), to(T0))


def _compare(j, t, atol=1e-5):
    np.testing.assert_allclose(t.estimate.numpy(), np.asarray(j.estimate), atol=atol)
    assert float(t.num_corr) == float(j.num_corr)
    assert float(t.num_inliers) == float(j.num_inliers)
    np.testing.assert_allclose(float(t.chi), float(j.chi), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(t.chi_inl_sum), float(j.chi_inl_sum), rtol=1e-4,
                               atol=1e-6)
    js, ts = np.asarray(j.iter_stats), t.iter_stats.numpy()
    assert ts.shape == js.shape
    np.testing.assert_array_equal(ts[:, 1:3], js[:, 1:3])
    np.testing.assert_allclose(ts[:, [0, 3]], js[:, [0, 3]], rtol=1e-4, atol=1e-6)


def _both(fixed, extr, moving, T0, **kw):
    kw = dict(KW, **kw)
    j = jma.fused_projective_align_multi(
        JP, *_kernel_args(fixed, extr, moving, T0, jnp.asarray), odom_prior=jnp.asarray(T0),
        interpret=True, **kw)
    before = mak.launches
    t = mak.fused_projective_align_multi(TP, *_kernel_args(fixed, extr, moving, T0, _t),
                                         odom_prior=_t(T0), **kw)
    assert mak.launches == before          # CPU tensors take the plain version
    return j, t


@pytest.mark.parametrize("odom_weight", [1.0, 0.0])
def test_plain_version_matches_pallas_interpret(inputs, odom_weight):
    j, t = _both(*inputs, odom_weight=odom_weight)
    _compare(j, t)
    assert float(t.num_inliers) > 150     # both cues matched (one cue sees < 103 beams)
    assert float(t.iter_stats[0, 2]) > 0


@pytest.mark.parametrize("case", ["damping", "min_corr_blocks", "no_valid_cue", "rear_only"])
def test_constructed_cases_match_pallas_interpret(inputs, case):
    fixed, extr, moving, T0 = inputs
    kw = {}
    if case == "damping":
        kw = dict(damping=50.0)
    elif case == "min_corr_blocks":
        kw = dict(min_corr=100000)
    elif case == "no_valid_cue":
        fixed = fixed._replace(valid=fixed.valid.at[0].set(False))
    else:   # the pi-rotated rear cue as the only cue
        fixed = jax.tree.map(lambda x: x[1:], fixed)
        extr = extr[1:]
    j, t = _both(fixed, extr, moving, T0, **kw)
    _compare(j, t)
    if case == "min_corr_blocks":
        np.testing.assert_array_equal(t.estimate.numpy(), T0)
    if case == "no_valid_cue":
        assert float(t.num_corr) > 0


@pytest.mark.parametrize("odom_weight,damping", [(1.0, 0.0), (0.0, 0.0), (1.0, 20.0)])
def test_align_multi_matches_jax(inputs, odom_weight, damping):
    fixed, extr, moving, T0 = inputs
    cfg_kw = dict(max_iterations=6, point_distance=0.5, normal_cos=0.8, chi_threshold=0.05,
                  odom_weight=odom_weight, damping=damping)
    j = jicp.align_multi(jicp.AlignerConfig(**cfg_kw), JP, fixed, extr, moving,
                         jnp.asarray(T0), odom_prior=jnp.asarray(T0))
    t = ticp.align_multi(ticp.AlignerConfig(**cfg_kw), TP, _tc(fixed), _t(extr), _tc(moving),
                         _t(T0), odom_prior=_t(T0))
    np.testing.assert_allclose(t.estimate.numpy(), np.asarray(j.estimate), atol=1e-5)
    assert int(t.num_correspondences) == int(j.num_correspondences) > 150
    assert int(t.num_inliers) == int(j.num_inliers)
    assert int(t.iterations) == int(j.iterations)
    np.testing.assert_array_equal(t.stats.numpy()[:, 1:3], np.asarray(j.stats)[:, 1:3])
    np.testing.assert_allclose(t.stats.numpy()[:, [0, 3]], np.asarray(j.stats)[:, [0, 3]],
                               rtol=1e-4, atol=1e-6)


def test_align_multi_guard_keeps_the_initial_guess(inputs):
    fixed, extr, moving, T0 = inputs
    cfg = ticp.AlignerConfig(max_iterations=3, min_num_correspondences=100000)
    t = ticp.align_multi(cfg, TP, _tc(fixed), _t(extr), _tc(moving), _t(T0), odom_prior=_t(T0))
    np.testing.assert_allclose(t.estimate.numpy(), T0, atol=1e-7)


def test_remap_sums9_is_the_matrix_form():
    rng = np.random.default_rng(3)
    J = rng.normal(size=(20, 3))
    H, b = J.T @ J, rng.normal(size=3)
    for e in (FRONT, REAR, (0.1, -0.3, 0.7)):
        ce, se = np.cos(e[2]), np.sin(e[2])
        inv_e = np.array([-(ce * e[0] + se * e[1]), -(-se * e[0] + ce * e[1]), -e[2]])
        ci, si = np.cos(inv_e[2]), np.sin(inv_e[2])
        a02 = ce * (-e[1]) + se * e[0]
        a12 = -se * (-e[1]) + ce * e[0]
        A = np.array([[ci, -si, a02], [si, ci, a12], [0.0, 0.0, 1.0]])
        sums9 = [torch.tensor(v, dtype=torch.float64) for v in
                 (H[0, 0], H[0, 1], H[0, 2], H[1, 1], H[1, 2], H[2, 2], *b)]
        r = [float(v) for v in mak.remap_sums9(sums9, *(torch.tensor(v) for v in
                                                         (ci, -si, a02, si, ci, a12)))]
        R = A.T @ H @ A
        np.testing.assert_allclose(r[:6], [R[0, 0], R[0, 1], R[0, 2], R[1, 1], R[1, 2],
                                           R[2, 2]], rtol=1e-12)
        np.testing.assert_allclose(r[6:], A.T @ b, rtol=1e-12)
        # the host-side cue constants hold inverse(e) and the same column
        cue = mak.cue_constants(torch.tensor([e], dtype=torch.float32))[0].numpy()
        np.testing.assert_allclose(cue[:5], [*inv_e, a02, a12], atol=1e-6)
