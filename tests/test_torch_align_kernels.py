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
from srrg2_laser_slam_2d_tpu_torch.bench.synthetic import tie_counts, with_tied_rows
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


def _compare(j, t, min_corr=50):
    np.testing.assert_allclose(t.estimate.numpy(), np.asarray(j.estimate), atol=1e-5)
    assert float(t.num_corr) == float(j.num_corr) > min_corr
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


def _with_ties(xy, nm, valid, seed, beam_indexed=False):
    """numpy in, numpy out: ``bench.synthetic.with_tied_rows`` of the cloud."""
    c = with_tied_rows(Cloud(_t(xy), _t(nm), _t(valid)), seed, beam_indexed)
    return c.xy.numpy(), c.normal.numpy(), c.valid.numpy()


def _tie_counts(xy, valid, T, proj: PolarProjection, B: int) -> set:
    """How many rows tie at the closest depth on each beam the cloud hits,
    moved by T."""
    return tie_counts(Cloud(_t(xy), _t(xy), _t(valid)), (proj, _t(T), B))


@pytest.mark.parametrize("odom_weight", [1.0, 0.0], ids=["prior", "no-prior"])
@pytest.mark.parametrize("beams", [128, 256])
@pytest.mark.parametrize("kernel", ["dense", "banded"])
def test_plain_versions_match_pallas_interpret_on_tied_depths(pair, kernel, beams,
                                                              odom_weight):
    """Both aligners on clouds with duplicated rows: two- and three-way
    bitwise depth ties on some beams of the fixed canvas and (dense) of the
    moving z-buffer, where the tied rows' normals differ. Pins the tie rule
    (the mean over the tied rows) that the kernels are held to on the card."""
    m1, st = pair
    jp = JProjection.make(cols=beams, angle_min=-np.pi, angle_max=np.pi, range_min=0.3,
                          range_max=20.0)
    tp = PolarProjection(*jp)
    clip = jclip.clip_projective(jp, st.scene, st.robot_in_local_map, st.sensor_in_robot, 0.0)
    fixed = _with_ties(m1.xy, m1.normal, m1.valid, seed=1)
    moving = _with_ties(clip.xy, clip.normal, clip.valid, seed=2,
                        beam_indexed=kernel == "banded")
    B = max(-(-beams // 128) * 128, 256 if kernel == "banded" else 0)
    assert {2, 3} <= _tie_counts(fixed[0], fixed[2], np.zeros(3, np.float32), tp, B)
    if kernel == "dense":
        assert {2, 3} <= _tie_counts(moving[0], moving[2], T0, tp, B)
    jfn, tfn, mod = ((jpa.fused_projective_align, pak.fused_projective_align, pak)
                     if kernel == "dense" else
                     (jba.fused_projective_align_banded, bak.fused_projective_align_banded, bak))
    kw = dict(KW, odom_weight=odom_weight)
    j = jfn(jp, *(jnp.asarray(a) for a in fixed + moving), jnp.asarray(T0),
            odom_prior=jnp.asarray(T0), interpret=True, **kw)
    before = mod.launches
    t = tfn(tp, *(_t(a) for a in fixed + moving), _t(T0), odom_prior=_t(T0), **kw)
    assert mod.launches == before
    _compare(j, t, min_corr=40 if beams == 128 else 50)   # 128 beams see fewer cells


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


def _refused(case):
    """Arguments of ``aligner_inputs`` with one thing the kernels do not take."""
    spec = pak.align_spec(TP, 4, 0.5, 0.8, 0.05, 10, 1.0)
    xy = torch.zeros(64, 2)
    nm = torch.zeros(64, 2)
    valid = torch.ones(64, dtype=torch.bool)
    fixed, moving, B = [xy, nm, valid], [xy, nm, valid], spec.cols_padded
    t0, prior = torch.zeros(3), torch.zeros(3)
    if case == "beams":
        B = 1152
    elif case == "non-contiguous":
        moving[1] = torch.zeros(2, 64).T
    elif case == "float64":
        fixed[0] = xy.double()
    elif case == "valid-bytes":
        moving[2] = valid.to(torch.uint8)
    elif case == "shape":
        fixed[1] = torch.zeros(64, 3)
    elif case == "initial":
        t0 = torch.zeros(4)
    elif case == "prior":
        prior = torch.zeros(3, 1)
    return spec, B, fixed, moving, t0, prior


@pytest.mark.parametrize("case", ["beams", "prior", "non-contiguous", "float64",
                                  "valid-bytes", "shape", "initial"])
def test_wrapper_refuses_what_the_kernels_do_not_take(case):
    """The checks that ``launch_aligner`` makes before any launch, on the
    host (here with CPU tensors, which the wrappers never hand to a kernel)."""
    spec, B, fixed, moving, t0, prior = _refused(case)
    with pytest.raises(ValueError):
        pak.aligner_inputs(spec, B, fixed, moving, t0, prior, torch.device("cpu"))


def test_wrapper_takes_valid_inputs_and_builds_its_parameters_once():
    spec, B, fixed, moving, t0, prior = _refused("none")
    out = pak.aligner_inputs(spec, B, fixed, moving, t0.double(), prior, torch.device("cpu"))
    assert len(out) == 8 and out[6].dtype == torch.float32
    # any number of moving rows: a ball clip hands the dense kernel the whole scene
    scene = [torch.zeros(8192, 2), torch.zeros(8192, 2), torch.ones(8192, dtype=torch.bool)]
    assert pak.aligner_inputs(spec, B, fixed, scene, t0, prior, torch.device("cpu"))[3].shape \
        == (8192, 2)
    params = pak._launch_params(spec, B)
    assert pak._launch_params(spec, B) is params
    assert (params.B, params.iterations, params.use_prior) == (256, 4, 1)


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
