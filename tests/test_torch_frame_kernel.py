"""Frame kernel port (srrg2_laser_slam_2d_tpu_torch/ops/frame_kernel.py):
the plain PyTorch version against the JAX Pallas kernel in interpret mode,
from the same numpy inputs (seeded synthetic scans, B = 384), in both
measurement layouts (pre-z-buffered canvases and raw [T, F, 8] rows)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.bench import pipeline, synthetic
from srrg2_laser_slam_2d_tpu.models import fast_tracker as jft
from srrg2_laser_slam_2d_tpu.models.preprocessor import PreprocessorConfig
from srrg2_laser_slam_2d_tpu.ops import pallas_frame as jpf
from srrg2_laser_slam_2d_tpu.ops.pallas_projector import _atan2 as jax_atan2
from srrg2_laser_slam_2d_tpu.ops.projector import PolarProjection as JProj
from srrg2_laser_slam_2d_tpu_torch.ops import _beam_kernels as tbk
from srrg2_laser_slam_2d_tpu_torch.ops import frame_kernel as tfk
from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection as TProj
from srrg2_laser_slam_2d_tpu_torch.utils.interop import state_from_numpy

T_FRAMES = 8


@pytest.fixture(scope="module")
def scans():
    """Seeded synthetic scans through the JAX preprocessor: (spec, cloud
    stack, odometry, state seeded from the first scan)."""
    jproj = JProj.make(cols=361, angle_min=-np.pi, angle_max=np.pi,
                       range_min=0.3, range_max=20.0)
    jspec = jpf.FrameSpec(projection=jproj, scene_capacity=1024, iterations=6,
                          odom_weight=1.0, meas_as_canvas=True)
    ds = synthetic.simulate(synthetic.SyntheticConfig(
        steps=T_FRAMES + 1, num_beams=361, seed=5, max_variance=0.02,
        drift=(0.06, 0.0, 0.02)))
    pcfg = PreprocessorConfig(voxelize_resolution=0.02, normal_window=8)
    stack = pipeline.preprocess_batch(ds.projection, pcfg, jnp.asarray(ds.ranges))
    od = jnp.asarray(ds.robot_poses)
    st = jft.seed(jspec, jax.tree.map(lambda x: x[0], stack),
                  np.array(ds.config.sensor_in_robot, np.float32), odom=od[0])
    return jspec, stack, od, st


@pytest.fixture(scope="module")
def chunk(scans):
    jspec, stack, od, st = scans
    measC = jft.pack_measurement_canvas_batch(
        jspec, jax.tree.map(lambda x: x[1:], stack), od[1:])
    return jspec, np.asarray(st.cacheT), np.asarray(st.pose), np.asarray(measC)


@pytest.fixture(scope="module")
def raw_chunk(scans):
    """The same frames in the raw [T, F, 8] layout (meas_as_canvas=False)."""
    jspec, stack, od, st = scans
    measF = jft.pack_measurement_batch(jax.tree.map(lambda x: x[1:], stack), od[1:])
    return (dataclasses.replace(jspec, meas_as_canvas=False), np.asarray(st.cacheT),
            np.asarray(st.pose), np.asarray(measF))


def _tspec(jspec):
    p = jspec.projection
    return tfk.FrameSpec(
        projection=TProj(*p), scene_capacity=jspec.scene_capacity,
        iterations=jspec.iterations, point_distance=jspec.point_distance,
        normal_cos=jspec.normal_cos, chi_threshold=jspec.chi_threshold,
        min_inliers=jspec.min_inliers, odom_weight=jspec.odom_weight,
        merge_threshold=jspec.merge_threshold, merge_shift=jspec.merge_shift,
        window=jspec.window, meas_as_canvas=jspec.meas_as_canvas,
        split_distance=jspec.split_distance)


def _run_both(jspec, cacheT, pose, meas):
    """The Pallas kernel in interpret mode and the port's wrapper (its plain
    version on CPU tensors) on the same inputs."""
    jout = jpf.track_frames_grid(jspec, jnp.asarray(cacheT), jnp.asarray(pose),
                                 jnp.asarray(meas), interpret=True)
    tout = tfk.track_frames_grid(_tspec(jspec), state_from_numpy(cacheT),
                                 state_from_numpy(pose), state_from_numpy(meas))
    return [np.asarray(x) for x in jout], [x.numpy() for x in tout]


@pytest.mark.parametrize("split_distance", [0.0, 0.15])
def test_plain_track_frames_grid_matches_pallas(chunk, split_distance):
    jspec, cacheT, pose, measC = chunk
    jspec = dataclasses.replace(jspec, split_distance=split_distance)
    _assert_frames_agree(*_run_both(jspec, cacheT, pose, measC), split_distance)


@pytest.mark.parametrize("split_distance", [0.0, 0.15])
def test_plain_track_frames_grid_matches_pallas_raw_layout(raw_chunk, split_distance):
    """The raw layout: the kernel z-buffers the rows itself each frame and
    reads the odometry from column 5; same tolerances as the canvas layout.
    The reference is the Pallas kernel stepped frame by frame
    (``frame_step``, interpret mode): on this chunk the JAX package's own
    ``track_frames_grid`` parts from that chain at frame 4 (estimates 2e-5
    apart, then merge decisions), in the order of XLA's sums."""
    jspec, cacheT, pose, measF = raw_chunk
    assert measF.ndim == 3 and measF.shape[2] == 8
    jspec = dataclasses.replace(jspec, split_distance=split_distance)
    jc, jp, pays = jnp.asarray(cacheT), jnp.asarray(pose), []
    for t in range(measF.shape[0]):
        jc, jp, pay = jpf.frame_step(jspec, jnp.asarray(measF[t]), jc, jp, interpret=True)
        pays.append(np.asarray(pay))
    tout = tfk.track_frames_grid(_tspec(jspec), state_from_numpy(cacheT),
                                 state_from_numpy(pose), state_from_numpy(measF))
    _assert_frames_agree((np.asarray(jc), np.asarray(jp), np.stack(pays)),
                         [x.numpy() for x in tout], split_distance)


def test_pack_measurement_matches_jax(scans):
    """The raw rows the fast tracker packs for meas_as_canvas=False, one
    frame and a stack."""
    from srrg2_laser_slam_2d_tpu_torch.models import fast_tracker as tft
    from srrg2_laser_slam_2d_tpu_torch.utils.cloud import Cloud

    _, stack, od, _ = scans
    jc = jax.tree.map(lambda x: x[1], stack)
    want = np.asarray(jft.pack_measurement(jc, od[1], True))
    got = tft.pack_measurement(Cloud(*(torch.from_numpy(np.array(x)) for x in jc)),
                               np.asarray(od[1]), True)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jft.pack_measurement_batch(stack, od))
    got = tft.pack_measurement_batch(Cloud(*(torch.from_numpy(np.array(x)) for x in stack)),
                                     torch.from_numpy(np.array(od)))
    np.testing.assert_array_equal(got.numpy(), want)


def _assert_frames_agree(jout, tout, split_distance):
    (jc, jp, jpay), (tc, tp, tpay) = jout, tout
    splits = jpay[:, 6, 7]
    if split_distance > 0:
        assert splits.sum() >= 1, "the case must split inside the chunk"
    np.testing.assert_array_equal(tpay[:, 6, 7], splits)
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    # per-frame stats: T', X' and the scene count
    np.testing.assert_allclose(tpay[:, 6, 0:3], jpay[:, 6, 0:3], atol=1e-4)
    np.testing.assert_allclose(tpay[:, 6, 8:12], jpay[:, 6, 8:12], atol=1e-4)
    kind_eq = tpay[:, 5] == jpay[:, 5]
    assert kind_eq.mean() >= 0.995, kind_eq.mean()
    target_eq = tpay[:, 4] == jpay[:, 4]
    assert target_eq.mean() >= 0.995, target_eq.mean()
    live = kind_eq & (jpay[:, 5] > 0)
    for r in range(4):
        np.testing.assert_allclose(tpay[:, r][live], jpay[:, r][live], atol=1e-4)
    np.testing.assert_allclose(tc[0:4], jc[0:4], atol=1e-4)


def test_atan2_poly_bit_equal():
    ang = np.linspace(-np.pi, np.pi, 4001, dtype=np.float32)
    r = np.float32(1.0) + np.arange(ang.size, dtype=np.float32) % 7
    x, y = r * np.cos(ang), r * np.sin(ang)
    x = np.concatenate([x, [0.0, -1.0, 1.0, 0.0, -0.0]]).astype(np.float32)
    y = np.concatenate([y, [1.0, 0.0, 0.0, -1.0, 1.0]]).astype(np.float32)
    want = np.asarray(jax_atan2(jnp.asarray(y), jnp.asarray(x)))
    got = tbk.atan2_poly(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_shift_zbuffer_ties_go_to_highest_source_lane():
    """Constructed ties: several cells at the same depth target one beam
    from different lanes; the Pallas roll enumeration (shifts -32..+32)
    must hand the beam to the highest source lane, as the port does."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from srrg2_laser_slam_2d_tpu.ops import _beam_kernels as jbk

    B = 128
    rng = np.random.default_rng(0)
    col = np.full(B, -1, np.int32)
    d = np.full(B, 5.0, np.float32)
    okp = np.zeros(B, bool)
    # beam 40 <- lanes 20, 40, 60 (tie at 2.0); beam 90 <- lanes 70, 100
    # (tie at 3.0) and lane 95 (farther); beam 10 <- lane 50 (out of band)
    for lane, beam, depth in [(20, 40, 2.0), (40, 40, 2.0), (60, 40, 2.0),
                              (70, 90, 3.0), (100, 90, 3.0), (95, 90, 3.5),
                              (50, 10, 1.0)]:
        col[lane], d[lane], okp[lane] = beam, depth, True
    free = [k for k in range(B)
            if not okp[k] and all(abs(k - c) > 6 for c in (10, 40, 90))]
    extra = rng.choice(free, 30, replace=False)
    for lane in extra:   # scattered single hits near home
        col[lane] = min(B - 1, max(0, lane + int(rng.integers(-3, 4))))
        d[lane], okp[lane] = float(rng.uniform(1.0, 4.0)), True
    vals = np.zeros((8, B), np.float32)
    vals[0] = np.arange(B)

    def kernel(v_ref, d_ref, c_ref, o_ref, out_ref):
        smin, svals, s_ok = jbk.beam_zbuffer_by_shifts(
            v_ref[:], d_ref[:], c_ref[:], o_ref[:] > 0, 32)
        out_ref[:] = jnp.concatenate(
            [smin, svals[0:1], s_ok.astype(jnp.float32),
             jnp.zeros((5, B), jnp.float32)], 0)

    out = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((8, B), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 4,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True,
    )(jnp.asarray(vals), jnp.asarray(d[None]), jnp.asarray(col[None]),
      jnp.asarray(okp[None].astype(np.int32))))
    smin, svals, s_ok = tbk.beam_zbuffer_by_shifts(
        torch.from_numpy(vals), torch.from_numpy(d), torch.from_numpy(col).long(),
        torch.from_numpy(okp), 32)
    assert out[1, 40] == 60 and out[1, 90] == 100 and out[2, 10] == 0
    np.testing.assert_array_equal(s_ok.numpy(), out[2] > 0)
    np.testing.assert_array_equal(svals[0].numpy(), out[1])
    ok = out[2] > 0
    np.testing.assert_array_equal(smin.numpy()[ok], out[0][ok])


def test_frame_step_chain_equals_one_grid_launch(chunk):
    """frame_step (the kernel at T = 1) stepped frame by frame carries the
    same state as one grid launch over the chunk."""
    jspec, cacheT, pose, measC = chunk
    spec = _tspec(dataclasses.replace(jspec, split_distance=0.15))
    c, p, meas = state_from_numpy(cacheT), state_from_numpy(pose), state_from_numpy(measC)
    gc, gp, gpay = tfk.track_frames_grid(spec, c, p, meas)
    pays = []
    for t in range(meas.shape[0]):
        c, p, pay = tfk.frame_step(spec, meas[t], c, p)
        pays.append(pay)
    torch.testing.assert_close(torch.stack(pays), gpay, rtol=0, atol=0)
    torch.testing.assert_close(p, gp, rtol=0, atol=0)
    torch.testing.assert_close(c, gc, rtol=0, atol=0)


def test_iteration_stats_match_the_pallas_frame_step(scans):
    """``FastTracker.iteration_stats`` (payload row 7: chi in lanes [0:its],
    inliers in [64:64+its]) of the port's plain frame step against the JAX
    tracker's, its Pallas ``frame_step`` in interpret mode, over three
    frames from one seeded state: chi within 1e-5 relative, inliers
    EQUAL."""
    from srrg2_laser_slam_2d_tpu_torch.models import fast_tracker as tft

    jspec, stack, od, st = scans
    sir = np.array(st.pose[1, 0:3], np.float32)
    jtr = jft.FastTracker(jspec, sir)
    jtr.state = st
    ttr = tft.FastTracker(_tspec(jspec), sir, device="cpu")
    ttr.state = state_from_numpy(st)
    assert jtr.iteration_stats() is None and ttr.iteration_stats() is None
    for t in range(1, 4):
        cloud = jax.tree.map(lambda x: x[t], stack)
        jtr.compute(cloud, np.array(od[t]))
        ttr.compute(state_from_numpy(cloud), np.array(od[t]))
        want, got = np.asarray(jtr.iteration_stats()), ttr.iteration_stats().numpy()
        assert got.shape == want.shape == (jspec.iterations, 2)
        assert (want[:, 1] > 0).all()
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5, atol=0)
        np.testing.assert_array_equal(got[:, 1], want[:, 1])
