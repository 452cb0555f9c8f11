"""K-stream frame kernel port (srrg2_laser_slam_2d_tpu_torch/ops/
stream_kernel.py): the plain PyTorch version against the JAX Pallas kernel
in interpret mode, from the same numpy inputs (K = 3 different seeded
streams, T = 4 frames, 181 beams so B = 256), for both gather bands and
correspondence refresh 1 and 2.

Tolerances: both sides run the same float32 operations; XLA on the CPU
fuses multiply-adds and sums in another order, so poses, payload points
and caches agree to 1e-4 (the tolerance of tests/test_stream_batch.py),
while merge kinds, target rows and scene counts are equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.bench import pipeline, synthetic
from srrg2_laser_slam_2d_tpu.models import fast_tracker as jft
from srrg2_laser_slam_2d_tpu.models.preprocessor import PreprocessorConfig
from srrg2_laser_slam_2d_tpu.ops import pallas_frame as jpf
from srrg2_laser_slam_2d_tpu.ops import pallas_stream as jps
from srrg2_laser_slam_2d_tpu.ops.projector import PolarProjection as JProj
from srrg2_laser_slam_2d_tpu_torch.ops import _beam_kernels as tbk
from srrg2_laser_slam_2d_tpu_torch.ops import frame_kernel as tfk
from srrg2_laser_slam_2d_tpu_torch.ops import stream_kernel as tsk
from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection as TProj
from srrg2_laser_slam_2d_tpu_torch.utils.interop import state_from_numpy

K = 3
T = 4
NUM_BEAMS = 181

# (stream_gather, corr_refresh, iterations, window): iterations = 5 with
# refresh 2 runs the masked tail of the refresh loop; window = 128 is the
# throughput benchmark's, where a beam crossing a block edge goes unmatched
CASES = [("onehot", 1, 4, 256), ("roll", 1, 4, 256),
         ("onehot", 2, 5, 128), ("roll", 2, 4, 256)]


def _case_id(case):
    return "{}-r{}-it{}-w{}".format(*case)


@functools.lru_cache(maxsize=None)
def _inputs():
    """K different streams as numpy: per-stream caches [K, 8, B], pose
    blocks [K, 2, 8], canvases [K, T, 8, B] (odometry in row 6), odometry
    [K, T, 3], and the JAX base spec."""
    proj = JProj.make(cols=NUM_BEAMS, angle_min=-np.pi, angle_max=np.pi,
                      range_min=0.3, range_max=20.0)
    jspec = jpf.FrameSpec(scene_capacity=512, projection=proj, iterations=4,
                          odom_weight=1.0, meas_as_canvas=True)
    pcfg = PreprocessorConfig(voxelize_resolution=0.02, normal_window=8)
    caches, poses, meas, odoms = [], [], [], []
    for k in range(K):
        ds = synthetic.simulate(synthetic.SyntheticConfig(
            steps=T, num_beams=NUM_BEAMS, seed=17 + k))
        stack = pipeline.preprocess_batch(ds.projection, pcfg, jnp.asarray(ds.ranges))
        od = jnp.asarray(ds.robot_poses)
        st = jft.seed(jspec, jax.tree.map(lambda x: x[0], stack),
                      np.array(ds.config.sensor_in_robot, np.float32), odom=od[0])
        mC = jft.pack_measurement_canvas_batch(
            jspec, jax.tree.map(lambda x: x[1:], stack), od[1:])
        caches.append(np.asarray(st.cacheT))
        poses.append(np.asarray(st.pose))
        meas.append(np.asarray(mC))
        odoms.append(np.asarray(od[1:]))
    return jspec, np.stack(caches), np.stack(poses), np.stack(meas), np.stack(odoms)


def _jspec(case):
    gather, refresh, iterations, window = case
    return dataclasses.replace(_inputs()[0], stream_gather=gather, corr_refresh=refresh,
                               iterations=iterations, window=window)


def _tspec(jspec):
    return tfk.FrameSpec(
        projection=TProj(*jspec.projection), scene_capacity=jspec.scene_capacity,
        iterations=jspec.iterations, point_distance=jspec.point_distance,
        normal_cos=jspec.normal_cos, chi_threshold=jspec.chi_threshold,
        min_inliers=jspec.min_inliers, odom_weight=jspec.odom_weight,
        merge_threshold=jspec.merge_threshold, merge_shift=jspec.merge_shift,
        window=jspec.window, meas_as_canvas=True,
        stream_gather=jspec.stream_gather, stream_band_shift=jspec.stream_band_shift,
        corr_refresh=jspec.corr_refresh)


def _packed_torch():
    """The port's batched inputs (odometry lanes of row 6 cleared)."""
    _, caches, poses, meas, odoms = _inputs()
    clean = meas.copy()
    clean[:, :, 6, :] = 0.0
    cacheB, poseB = tsk.pack_stream_state(state_from_numpy(caches), state_from_numpy(poses))
    measC, odomS = tsk.pack_stream_measurements(state_from_numpy(clean),
                                                state_from_numpy(odoms))
    return cacheB, poseB, measC, odomS


@functools.lru_cache(maxsize=None)
def _port_rollout(case):
    return tsk.track_streams_grid(_tspec(_jspec(case)), *_packed_torch())


def test_pack_adapters_match_jax_exactly():
    _, caches, poses, meas, odoms = _inputs()
    jc, jp = jps.pack_stream_state(jnp.asarray(caches), jnp.asarray(poses))
    jm, jo = jps.pack_stream_measurements(jnp.asarray(meas), jnp.asarray(odoms))
    tc, tp = tsk.pack_stream_state(state_from_numpy(caches), state_from_numpy(poses))
    tm, to = tsk.pack_stream_measurements(state_from_numpy(meas), state_from_numpy(odoms))
    for got, want in ((tc, jc), (tp, jp), (tm, jm), (to, jo)):
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tm.shape == (T, 8, K, 256) and to.shape == (T, K, 8)
    uc, up = tsk.unpack_stream_state(tc, tp)
    jc2, jp2 = jps.unpack_stream_state(jc, jp)
    np.testing.assert_array_equal(uc.numpy(), np.asarray(jc2))
    np.testing.assert_array_equal(up.numpy(), np.asarray(jp2))
    valid = np.zeros((K, T), np.float32)
    valid[1, 2] = 1.0
    _, to2 = tsk.pack_stream_measurements(state_from_numpy(meas), state_from_numpy(odoms),
                                          state_from_numpy(valid))
    _, jo2 = jps.pack_stream_measurements(jnp.asarray(meas), jnp.asarray(odoms),
                                          jnp.asarray(valid))
    np.testing.assert_array_equal(to2.numpy(), np.asarray(jo2))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_streams_match_pallas(case):
    jspec = _jspec(case)
    _, caches, poses, meas, odoms = _inputs()
    clean = meas.copy()
    clean[:, :, 6, :] = 0.0
    jcB, jpB = jps.pack_stream_state(jnp.asarray(caches), jnp.asarray(poses))
    jmC, joS = jps.pack_stream_measurements(jnp.asarray(clean), jnp.asarray(odoms))
    jc, jp, jpay = jps.track_streams_grid(jspec, jcB, jpB, jmC, joS, interpret=True)
    jc, jp, jpay = np.asarray(jc), np.asarray(jp), np.asarray(jpay)
    tc, tp, tpay = (x.numpy() for x in _port_rollout(case))
    assert tpay.shape == (T, 8, K, 256)
    # the streams really differ, so a kernel that mixed them up would show
    assert not np.allclose(jp[0, 0:3], jp[1, 0:3], atol=1e-3)
    np.testing.assert_array_equal(tpay[:, 5], jpay[:, 5], err_msg="merge kinds")
    np.testing.assert_array_equal(tpay[:, 4], jpay[:, 4], err_msg="target rows")
    np.testing.assert_array_equal(tp[:, 7], jp[:, 7], err_msg="scene counts")
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4, err_msg="pose blocks")
    np.testing.assert_allclose(tpay[:, 0:4], jpay[:, 0:4], rtol=0, atol=1e-4,
                               err_msg="payload points")
    # stats lanes: T', then chi and counts; iteration row: chi and inliers
    np.testing.assert_allclose(tpay[:, 6, :, 0:3], jpay[:, 6, :, 0:3], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tpay[:, 6, :, 4:7], jpay[:, 6, :, 4:7])
    np.testing.assert_allclose(tpay[:, 6, :, 3], jpay[:, 6, :, 3], rtol=1e-3, atol=1e-4)
    its = jspec.iterations
    np.testing.assert_array_equal(tpay[:, 7, :, 64:64 + its], jpay[:, 7, :, 64:64 + its])
    np.testing.assert_allclose(tpay[:, 7, :, 0:its], jpay[:, 7, :, 0:its],
                               rtol=1e-3, atol=1e-4)
    assert (tpay[:, 7, :, its:64] == 0).all() and (tpay[:, 7, :, 64 + its:] == 0).all()
    np.testing.assert_allclose(tc[0:4], jc[0:4], rtol=0, atol=1e-4, err_msg="cache cells")
    np.testing.assert_array_equal(tc[4:8], jc[4:8], err_msg="cache valid / rows")


@pytest.mark.parametrize("case", [CASES[1], CASES[2]], ids=_case_id)
def test_stream_step_matches_grid(case):
    """stream_step (T = 1) stepped frame by frame carries the same state as
    one grid call over the stack."""
    spec = _tspec(_jspec(case))
    cB, pB, measC, odomS = _packed_torch()
    gc, gp, gpay = _port_rollout(case)
    pays = []
    for t in range(T):
        cB, pB, pay = tsk.stream_step(spec, measC[t], odomS[t], cB, pB)
        pays.append(pay)
    torch.testing.assert_close(torch.stack(pays), gpay, rtol=0, atol=1e-6)
    torch.testing.assert_close(pB, gp, rtol=0, atol=1e-6)
    torch.testing.assert_close(cB, gc, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", [CASES[0], CASES[1]], ids=_case_id)
def test_each_stream_matches_the_single_stream_plain_version(case):
    """Stream k of the K-stream plain version against the port's own
    single-stream plain version on stream k alone (no split, refresh 1):
    the same merge decisions, geometry within 1e-4."""
    spec = _tspec(_jspec(case))
    _, caches, poses, meas, _ = _inputs()
    _, tp, tpay = _port_rollout(case)
    for k in range(K):
        sc, sp, spay = tfk.track_frames_grid_plain(
            spec, state_from_numpy(caches[k]), state_from_numpy(poses[k]),
            state_from_numpy(meas[k]))
        np.testing.assert_array_equal(tpay[:, 5, k].numpy(), spay[:, 5].numpy())
        np.testing.assert_array_equal(tpay[:, 4, k].numpy(), spay[:, 4].numpy())
        torch.testing.assert_close(tpay[:, 0:4, k], spay[:, 0:4], rtol=0, atol=1e-4)
        torch.testing.assert_close(tp[k, 0:8], sp[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(tpay[:, 6, k, 0:7], spay[:, 6, 0:7], rtol=1e-3, atol=1e-4)


def test_batched_zbuffer_ties_go_to_highest_source_lane():
    """Constructed ties, different in each stream: the batched z-buffer
    hands a beam to the highest source lane among the closest cells, stream
    by stream as the single-stream rule (pinned against interpret mode in
    tests/test_torch_frame_kernel.py) does."""
    B = 128
    plans = [
        [(20, 40, 2.0), (40, 40, 2.0), (60, 40, 2.0), (70, 90, 3.0), (100, 90, 3.0)],
        [(30, 40, 2.0), (45, 40, 2.0), (95, 90, 3.5), (91, 90, 3.5), (50, 10, 1.0)],
        [(8, 40, 1.0), (41, 40, 1.0), (72, 40, 1.0), (12, 44, 4.0)],
    ]
    expect = [{40: 60, 90: 100}, {40: 45, 90: 95}, {40: 72, 44: 12}]
    col = np.full((3, B), -1, np.int64)
    d = np.full((3, B), 5.0, np.float32)
    okp = np.zeros((3, B), bool)
    for k, plan in enumerate(plans):
        for lane, beam, depth in plan:
            col[k, lane], d[k, lane], okp[k, lane] = beam, depth, True
    vals = np.zeros((2, 3, B), np.float32)
    vals[0] = np.arange(B)
    vals[1] = 100.0 * np.arange(3)[:, None] + 1.0
    args = [torch.from_numpy(x) for x in (vals, d, col, okp)]
    smin, svals, s_ok = tbk.beam_zbuffer_by_shifts(*args, 32)
    for k in range(3):
        for beam, lane in expect[k].items():
            assert s_ok[k, beam] and svals[0, k, beam] == lane, (k, beam)
            assert svals[1, k, beam] == 100.0 * k + 1.0      # from its own stream
        assert int(s_ok[k].sum()) == len(expect[k])           # 50 -> 10 is out of band
        one = tbk.beam_zbuffer_by_shifts(args[0][:, k], args[1][k], args[2][k], args[3][k], 32)
        torch.testing.assert_close(smin[k], one[0], rtol=0, atol=0)
        torch.testing.assert_close(svals[:, k], one[1], rtol=0, atol=0)
        assert torch.equal(s_ok[k], one[2])


def test_operation_count_follows_the_refresh():
    """The count behind the kernel's bound: refresh 1 is the single-stream
    count; a larger refresh saves only the gathers it skips."""
    assert tsk.flops_per_lane_frame(10, 1) == tfk.flops_per_lane_frame(10)
    assert tsk.flops_per_lane_frame(10, 2) == tsk.flops_per_lane_frame(10, 1) - 4 * 5
    assert tsk.flops_per_lane_frame(5, 2) == tsk.flops_per_lane_frame(5, 1) - 4 * 2


def test_wrapper_checks_its_inputs():
    spec = _tspec(_jspec(CASES[0]))
    cB, pB, measC, odomS = _packed_torch()
    with pytest.raises(ValueError, match="stream_gather"):
        tsk.track_streams_grid(dataclasses.replace(spec, stream_gather="dense"),
                               cB, pB, measC, odomS)
    with pytest.raises(ValueError, match="unsupported device"):
        tsk.track_streams_grid(spec, cB.to("meta"), pB.to("meta"), measC.to("meta"),
                               odomS.to("meta"))
