"""The two aligner kernels' plain versions against the JAX package's Pallas
aligners in interpret mode (``fused_projective_align_banded``,
``fused_projective_align``), and ``build_canvasT`` with its tie rule.
Clouds: two consecutive scans of ``bench/synthetic.simulate`` (seed 0) at
256 beams, the moving side the projective clip of a scene seeded from the
first, 4 Gauss-Newton iterations.

Tolerances: estimates agree to 1e-5 and chi to rtol 1e-3 (XLA fuses
multiply-adds and sums in another order); counts are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.bench import pipeline, synthetic
from srrg2_laser_slam_2d_tpu.models import tracker as jtracker
from srrg2_laser_slam_2d_tpu.models.preprocessor import PreprocessorConfig
from srrg2_laser_slam_2d_tpu.ops import _beam_kernels as jbk
from srrg2_laser_slam_2d_tpu.ops import clip as jclip
from srrg2_laser_slam_2d_tpu.ops import pallas_banded_align as jba
from srrg2_laser_slam_2d_tpu.ops import pallas_projective_align as jpa
from srrg2_laser_slam_2d_tpu.ops import pallas_scene as jps
from srrg2_laser_slam_2d_tpu.ops.projector import PolarProjection as JProjection
from srrg2_laser_slam_2d_tpu_torch.models import tracker as ttracker
from srrg2_laser_slam_2d_tpu_torch.ops import _beam_kernels as tbk
from srrg2_laser_slam_2d_tpu_torch.ops import banded_align_kernel as bak
from srrg2_laser_slam_2d_tpu_torch.ops import projective_align_kernel as pak
from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection
from srrg2_laser_slam_2d_tpu_torch.utils.cloud import Cloud

BEAMS = 256
JP = JProjection.make(cols=BEAMS, angle_min=-np.pi, angle_max=np.pi, range_min=0.3,
                      range_max=20.0)
TP = PolarProjection(*JP)
KW = dict(iterations=4, point_distance=0.5, normal_cos=0.8, chi_threshold=0.05,
          odom_weight=1.0)
T0 = np.array([0.02, -0.01, 0.01], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def pair():
    """(measurement of frame 1, scene seeded from frame 0) as JAX clouds."""
    ds = synthetic.simulate(synthetic.SyntheticConfig(steps=3, num_beams=BEAMS))
    meas = pipeline.preprocess_batch(
        ds.projection, PreprocessorConfig(voxelize_resolution=0.02, normal_window=8),
        jnp.asarray(ds.ranges))
    cfg = jtracker.TrackerConfig(scene_capacity=512, projection=JP)
    st = jtracker.populate(cfg, jtracker.init_state(cfg), jax.tree.map(lambda x: x[0], meas))
    return jax.tree.map(lambda x: x[1], meas), st


def _compare(j, t):
    np.testing.assert_allclose(t.estimate.numpy(), np.asarray(j.estimate), atol=1e-5)
    assert float(t.num_corr) == float(j.num_corr) > 50
    assert float(t.num_inliers) == float(j.num_inliers)
    np.testing.assert_allclose(float(t.chi), float(j.chi), rtol=1e-3)
    np.testing.assert_allclose(float(t.chi_inl_sum), float(j.chi_inl_sum), rtol=1e-3)
    js, ts = np.asarray(j.iter_stats), t.iter_stats.numpy()
    assert ts.shape == js.shape == (KW["iterations"], 4)
    np.testing.assert_array_equal(ts[:, 1:3], js[:, 1:3])
    np.testing.assert_allclose(ts[:, [0, 3]], js[:, [0, 3]], rtol=1e-3)


@pytest.mark.parametrize("odom_weight", [1.0, 0.0])
def test_banded_plain_version_matches_pallas_interpret(pair, odom_weight):
    m1, st = pair
    clip = jclip.clip_projective(JP, st.scene, st.robot_in_local_map, st.sensor_in_robot, 0.0)
    kw = dict(KW, odom_weight=odom_weight)
    j = jba.fused_projective_align_banded(
        JP, m1.xy, m1.normal, m1.valid, clip.xy, clip.normal, clip.valid, jnp.asarray(T0),
        odom_prior=jnp.asarray(T0), interpret=True, **kw)
    before = bak.launches
    t = bak.fused_projective_align_banded(
        TP, _t(m1.xy), _t(m1.normal), _t(m1.valid), _t(clip.xy), _t(clip.normal),
        _t(clip.valid), _t(T0), odom_prior=_t(T0), **kw)
    assert bak.launches == before         # CPU tensors take the plain version
    _compare(j, t)


@pytest.mark.parametrize("clip_rows", ["beams", "padded"])
def test_dense_plain_version_matches_pallas_interpret(pair, clip_rows):
    """The dense aligner on the plain clip (one row per beam) and on the
    canvas kernel's clip (one row per padded beam; 256 beams pad to 256, so
    the scene is clipped at 200 beams there)."""
    m1, st = pair
    if clip_rows == "beams":
        clip = jclip.clip_projective(JP, st.scene, st.robot_in_local_map,
                                     st.sensor_in_robot, 0.0)
    else:
        narrow = JProjection.make(cols=200, angle_min=-np.pi, angle_max=np.pi,
                                  range_min=0.3, range_max=20.0)
        clip = jps.clip_projective_pallas(narrow, st.scene, st.robot_in_local_map,
                                          st.sensor_in_robot, chunk=256, interpret=True)
        assert clip.xy.shape[0] == 256
    j = jpa.fused_projective_align(
        JP, m1.xy, m1.normal, m1.valid, clip.xy, clip.normal, clip.valid, jnp.asarray(T0),
        odom_prior=jnp.asarray(T0), interpret=True, **KW)
    before = pak.launches
    t = pak.fused_projective_align(
        TP, _t(m1.xy), _t(m1.normal), _t(m1.valid), _t(clip.xy), _t(clip.normal),
        _t(clip.valid), _t(T0), odom_prior=_t(T0), **KW)
    assert pak.launches == before
    _compare(j, t)


def test_build_canvas_matches_jax_and_averages_ties(pair):
    m1, _ = pair
    fgeo = jba._pack(m1.xy, m1.normal, m1.valid)
    j = np.asarray(jbk.build_canvasT(fgeo, 256, JP))
    t = tbk.build_canvasT(_t(m1.xy[:, 0]), _t(m1.xy[:, 1]), _t(m1.normal[:, 0]),
                          _t(m1.normal[:, 1]), _t(m1.valid), 256, TP).numpy()
    np.testing.assert_array_equal(t[5], j[5])
    np.testing.assert_allclose(t, j, atol=1e-6)
    # two points at one depth on one beam are averaged, a farther one is hidden
    ang = (100.5 - TP.c) / TP.f
    ray = np.array([np.cos(ang), np.sin(ang)], np.float32)
    xy = np.stack([2.0 * ray, 2.0 * ray, 3.0 * ray]).astype(np.float32)
    nm = np.array([[1, 0], [0, 1], [1, 0]], np.float32)
    c = tbk.build_canvasT(_t(xy[:, 0]), _t(xy[:, 1]), _t(nm[:, 0]), _t(nm[:, 1]),
                          torch.ones(3, dtype=torch.bool), 256, TP)
    assert float(c[5].sum()) == 1.0 and float(c[0, 100]) == pytest.approx(2.0, abs=1e-6)
    np.testing.assert_allclose(c[3:5, 100].numpy(), [0.5, 0.5], atol=1e-6)
    jc = np.asarray(jbk.build_canvasT(jba._pack(jnp.asarray(xy), jnp.asarray(nm),
                                                jnp.ones(3, bool)), 256, JP))
    np.testing.assert_allclose(c.numpy(), jc, atol=1e-6)


def test_iteration_limit_and_beam_indexing_are_checked(pair):
    m1, st = pair
    args = [_t(m1.xy), _t(m1.normal), _t(m1.valid)] * 2 + [_t(T0)]
    for fn in (pak.fused_projective_align, bak.fused_projective_align_banded):
        with pytest.raises(ValueError, match="128 iterations"):
            fn(TP, *args, iterations=129)
    with pytest.raises(ValueError, match="beam-indexed"):
        bak.fused_projective_align_banded(TP, _t(m1.xy), _t(m1.normal), _t(m1.valid),
                                          _t(m1.xy[:100]), _t(m1.normal[:100]),
                                          _t(m1.valid[:100]), _t(T0))
    meta = [a.to("meta") for a in args]
    for fn in (pak.fused_projective_align, bak.fused_projective_align_banded):
        with pytest.raises(ValueError, match="device"):
            fn(TP, *meta)


def test_fused_scene_ops_with_banded_aligner_is_refused_as_in_jax():
    """A property of the reference: the canvas kernel's clip has one row per
    PADDED beam, which the banded aligner refuses whenever the beam count is
    not a multiple of 128 (721 beams: 768 rows). The port raises the same
    error."""
    ds = synthetic.simulate(synthetic.SyntheticConfig(steps=2, num_beams=200))
    jp = JProjection.make(cols=200, angle_min=-np.pi, angle_max=np.pi, range_min=0.3,
                          range_max=20.0)
    meas = pipeline.preprocess_batch(
        ds.projection, PreprocessorConfig(voxelize_resolution=0.02, normal_window=8),
        jnp.asarray(ds.ranges))
    flags = dict(use_fused_aligner=True, banded_aligner=True, use_fused_scene_ops=True)
    jcfg = jtracker.TrackerConfig(scene_capacity=256, projection=jp, **flags)
    jst = jtracker.populate(jcfg, jtracker.init_state(jcfg), jax.tree.map(lambda x: x[0], meas))
    m1 = jax.tree.map(lambda x: x[1], meas)
    with pytest.raises(ValueError, match="beam-indexed"):
        jtracker.track_step_impl(jcfg, jst, m1, jnp.zeros(3), jnp.asarray(False))
    tcfg = ttracker.TrackerConfig(scene_capacity=256, projection=PolarProjection(*jp), **flags)
    tm0, tm1 = (Cloud(_t(jax.tree.map(lambda x: x[k], meas).xy),
                      _t(jax.tree.map(lambda x: x[k], meas).normal),
                      _t(jax.tree.map(lambda x: x[k], meas).valid)) for k in (0, 1))
    tst = ttracker.populate(tcfg, ttracker.init_state(tcfg), tm0)
    with pytest.raises(ValueError, match="beam-indexed"):
        ttracker.track_step(tcfg, tst, tm1, torch.zeros(3), torch.tensor(False))
