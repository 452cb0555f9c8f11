"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without an NVIDIA card every test here skips (the
decision is taken inside the ``card`` fixture). Inputs come from numpy
only, so these tests run where JAX is not installed:

    python -m pytest tests/test_torch_cuda_kernels.py -q -p no:randomly --noconftest

(``--noconftest``: tests/conftest.py imports JAX, which a machine with the
card need not have.)

Tolerances: kernel and plain version round the same float32 operations in
the same order and differ only in the order of their block sums, so poses
and payload points agree to 1e-4 over 16 frames and NN-ICP estimates to
1e-4 (chip_smoke.py holds the full-width shapes to 1e-3)."""

import dataclasses

import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu_torch.models import fast_tracker as ft
from srrg2_laser_slam_2d_tpu_torch.models.preprocessor import (
    LaserModel, PreprocessorConfig, ScanPreprocessor)
from srrg2_laser_slam_2d_tpu_torch.ops import frame_kernel as fk
from srrg2_laser_slam_2d_tpu_torch.ops import nn_icp_kernel as nk
from srrg2_laser_slam_2d_tpu_torch.ops import stream_kernel as sk
from srrg2_laser_slam_2d_tpu_torch.utils.cloud import Cloud

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _room_ranges(poses: np.ndarray, beams: int) -> np.ndarray:
    """Ranges from a 10 m x 6 m room with a 1 m pillar, angles over +-pi."""
    ang = np.linspace(-np.pi, np.pi, beams, endpoint=False)
    boxes = [(-5.0, -3.0, 5.0, 3.0, True), (1.0, 0.5, 2.0, 1.5, False)]
    out = np.full((len(poses), beams), 100.0)
    for k, (x, y, th) in enumerate(poses):
        dx, dy = np.cos(th + ang), np.sin(th + ang)
        for x0, y0, x1, y1, inside in boxes:
            with np.errstate(divide="ignore", invalid="ignore"):
                tx0, tx1 = (x0 - x) / dx, (x1 - x) / dx
                ty0, ty1 = (y0 - y) / dy, (y1 - y) / dy
            tmin = np.maximum(np.minimum(tx0, tx1), np.minimum(ty0, ty1))
            tmax = np.minimum(np.maximum(tx0, tx1), np.maximum(ty0, ty1))
            t = tmax if inside else np.where((tmax >= tmin) & (tmin > 0), tmin, np.inf)
            out[k] = np.minimum(out[k], np.nan_to_num(t, nan=np.inf, posinf=100.0))
    return out.astype(np.float32)


def test_frame_kernel_matches_plain_on_card(card):
    T, beams = 16, 361
    poses = np.stack([np.linspace(-2.0, 0.5, T + 1), np.linspace(-1.0, 0.2, T + 1),
                      np.linspace(0.0, 0.4, T + 1)], 1)
    pcfg = PreprocessorConfig(voxelize_resolution=0.02, normal_window=8,
                              voxelize_mode="sequential")
    pre = ScanPreprocessor(pcfg, device=card)
    pre.set_model(LaserModel(beams, -np.pi, np.pi, 0.0, 30.0))
    clouds = pre.compute(_room_ranges(poses, beams))
    spec = fk.FrameSpec(projection=pre.projection, scene_capacity=2048, iterations=8,
                        split_distance=0.6)
    st = ft.seed(spec, clouds.map(lambda x: x[0]), np.zeros(3, np.float32),
                 odom=poses[0].astype(np.float32))
    measC = ft.pack_measurement_canvas_batch(
        spec, clouds.map(lambda x: x[1:]),
        torch.as_tensor(poses[1:], dtype=torch.float32, device=card))
    before = fk.launches
    kc, kp, kpay = fk.track_frames_grid(spec, st.cacheT, st.pose, measC)
    assert fk.launches == before + 1
    pc, pp, ppay = fk.track_frames_grid_plain(spec, st.cacheT, st.pose, measC)
    kpay, ppay = kpay.cpu().numpy(), ppay.cpu().numpy()
    assert ppay[:, 6, 7].sum() >= 1, "the chunk must split a local map"
    np.testing.assert_array_equal(kpay[:, 6, 7], ppay[:, 6, 7])
    np.testing.assert_allclose(kp.cpu().numpy(), pp.cpu().numpy(), atol=1e-4)
    kind_eq = kpay[:, 5] == ppay[:, 5]
    assert kind_eq.mean() >= 0.995 and (kpay[:, 4] == ppay[:, 4]).mean() >= 0.995
    live = kind_eq & (ppay[:, 5] > 0)
    for r in range(4):
        np.testing.assert_allclose(kpay[:, r][live], ppay[:, r][live], atol=1e-4)
    np.testing.assert_allclose(kc.cpu().numpy()[:4], pc.cpu().numpy()[:4], atol=1e-4)
    # frame_step is the same kernel with T = 1
    c1, p1, pay1 = fk.frame_step(spec, measC[0], st.cacheT, st.pose)
    np.testing.assert_allclose(pay1.cpu().numpy(), kpay[0], atol=1e-5)


def _room_streams(card, K: int, T: int, beams: int, spec_kw: dict):
    """K different drives through the room, packed for the K-stream kernel:
    (spec, seed states, cacheB, poseB, measC_stack, odom_stack)."""
    pcfg = PreprocessorConfig(voxelize_resolution=0.02, normal_window=8,
                              voxelize_mode="sequential")
    pre = ScanPreprocessor(pcfg, device=card)
    pre.set_model(LaserModel(beams, -np.pi, np.pi, 0.0, 30.0))
    spec = fk.FrameSpec(projection=pre.projection, scene_capacity=2048, **spec_kw)
    states, meas, odoms = [], [], []
    for k in range(K):
        u = np.linspace(0.0, 1.0, T + 1)
        poses = np.stack([-2.0 + (1.5 + 0.3 * k) * u, -1.0 + (0.2 * k) * u + 0.8 * u * u,
                          (0.3 - 0.15 * k) * u], 1)
        clouds = pre.compute(_room_ranges(poses, beams))
        states.append(ft.seed(spec, clouds.map(lambda x: x[0]), np.zeros(3, np.float32),
                              odom=poses[0].astype(np.float32)))
        meas.append(ft.pack_measurement_canvas_batch(spec, clouds.map(lambda x: x[1:])))
        odoms.append(torch.as_tensor(poses[1:], dtype=torch.float32, device=card))
    cacheB, poseB = sk.pack_stream_state(torch.stack([s.cacheT for s in states]),
                                         torch.stack([s.pose for s in states]))
    measC, odomS = sk.pack_stream_measurements(torch.stack(meas), torch.stack(odoms))
    return spec, states, cacheB, poseB, measC, odomS


@pytest.mark.parametrize("gather,refresh,iterations", [("onehot", 2, 7), ("roll", 1, 6),
                                                       ("onehot", 1, 6)])
def test_stream_kernel_matches_plain_on_card(card, gather, refresh, iterations):
    K, T = 5, 12
    spec, states, cacheB, poseB, measC, odomS = _room_streams(
        card, K, T, 361, dict(iterations=iterations, window=128, stream_gather=gather,
                              corr_refresh=refresh))
    before = sk.launches
    kc, kp, kpay = sk.track_streams_grid(spec, cacheB, poseB, measC, odomS)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    pc, pp, ppay = sk.track_streams_grid_plain(spec, cacheB, poseB, measC, odomS)
    assert not torch.allclose(pp[0, 0:3], pp[1, 0:3], atol=1e-2)      # streams differ
    np.testing.assert_allclose(kp.cpu().numpy(), pp.cpu().numpy(), atol=1e-4)
    kpay_n, ppay_n = kpay.cpu().numpy(), ppay.cpu().numpy()
    kind_eq = kpay_n[:, 5] == ppay_n[:, 5]
    assert kind_eq.mean() >= 0.995 and (kpay_n[:, 4] == ppay_n[:, 4]).mean() >= 0.995
    live = kind_eq & (ppay_n[:, 5] > 0)
    for r in range(4):
        np.testing.assert_allclose(kpay_n[:, r][live], ppay_n[:, r][live], atol=1e-4)
    np.testing.assert_allclose(kpay_n[:, 6, :, 0:7], ppay_n[:, 6, :, 0:7], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(kc.cpu().numpy()[:4], pc.cpu().numpy()[:4], atol=1e-4)
    # stream_step is the same kernel with T = 1
    c1, p1, pay1 = sk.stream_step(spec, measC[0], odomS[0], cacheB, poseB)
    np.testing.assert_allclose(pay1.cpu().numpy(), kpay_n[0], atol=1e-5)
    if gather == "onehot" and refresh == 1:
        # each stream against the single-stream CUDA kernel on that stream:
        # the same band, arithmetic and block sums
        for k in range(K):
            measF = measC[:, :, k].clone()
            measF[:, 6, 0:4] = odomS[:, k, 0:4]
            sc, sp, spay = fk.track_frames_grid(spec, states[k].cacheT, states[k].pose, measF)
            np.testing.assert_array_equal(kpay_n[:, 4:6, k], spay.cpu().numpy()[:, 4:6])
            np.testing.assert_allclose(kpay_n[:, 0:4, k], spay.cpu().numpy()[:, 0:4], atol=1e-6)
            np.testing.assert_allclose(kp[k, 0:8].cpu().numpy(), sp[0].cpu().numpy(), atol=1e-6)


def test_nn_icp_kernel_matches_plain_on_card(card):
    rng = np.random.default_rng(3)
    J, n = 8, 1000          # F = 1000 is not a multiple of the 512-point tile
    a = rng.uniform(-6, 6, (J, 6, 2))
    b = a + rng.uniform(-3, 3, (J, 6, 2))
    seg = rng.integers(0, 6, (J, n))
    u = rng.uniform(0, 1, (J, n, 1))
    p = np.take_along_axis(a, seg[..., None], 1) * (1 - u) + np.take_along_axis(
        b, seg[..., None], 1) * u
    d = np.take_along_axis(b - a, seg[..., None], 1)
    nrm = np.stack([-d[..., 1], d[..., 0]], -1) / np.linalg.norm(d, axis=-1, keepdims=True)
    th = rng.uniform(-0.08, 0.08, J)
    c, s = np.cos(th), np.sin(th)
    R = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)          # [J, 2, 2]
    t = rng.uniform(-0.3, 0.3, (J, 2))
    mxy = np.einsum("jni,jik->jnk", p - t[:, None], R) + rng.normal(0, 0.005, p.shape)
    mn = np.einsum("jni,jik->jnk", nrm, R)

    def cloud(xy, nm, v):
        return Cloud(torch.as_tensor(xy, dtype=torch.float32, device=card),
                     torch.as_tensor(nm, dtype=torch.float32, device=card),
                     torch.as_tensor(v, device=card))
    fixed = cloud(p, nrm, rng.uniform(size=(J, n)) > 0.05)
    moving = cloud(mxy, mn, rng.uniform(size=(J, n)) > 0.05)
    init = torch.zeros(J, 3, device=card)
    kw = dict(iterations=30, max_distance=1.414, normal_cos=0.8, chi_threshold=0.05,
              min_inliers=10, corr_refresh=3)
    before = nk.launches
    got = nk.fused_align_pairs(fixed, moving, init, **kw)
    assert nk.launches == before + 1
    fixedP = torch.nn.functional.pad(nk.pack_fixed(fixed), (0, 24))   # F -> 1024
    fixedP[:, 5, n:] = 1e30                                           # padding never matches
    est, stats = nk.fused_align_pairs_plain(
        fixedP, nk.pack_moving(moving), init, 30, 1.414 ** 2, 0.8, 0.05, 10, 3)
    np.testing.assert_allclose(got.estimate.cpu().numpy(), est.cpu().numpy(), atol=1e-4)
    ref = stats.cpu().numpy()[:, 1:3]
    mine = np.stack([got.num_inliers.cpu().numpy(), got.num_correspondences.cpu().numpy()], 1)
    assert np.all(np.abs(mine - ref) <= 0.01 * np.maximum(ref, 1.0))
    truth = np.concatenate([t, th[:, None]], 1)
    np.testing.assert_allclose(got.estimate.cpu().numpy(), truth, atol=0.02)


def test_chunked_runner_launches_both_kernels_on_card(card):
    from srrg2_laser_slam_2d_tpu_torch.io.messages import LaserMessage, OdometryMessage
    from srrg2_laser_slam_2d_tpu_torch.models.chunked_slam import ChunkedSlamRunner
    from srrg2_laser_slam_2d_tpu_torch.utils import config as config_mod

    mgr = config_mod.ConfigManager.read("configurations/corridor.json")
    cfg, pcfg = mgr.get_by_name("slam"), mgr.get_by_name("preprocessor")
    beams = cfg.tracker.projection.cols
    # two laps around the pillar so the second lap closes loops on the first
    ang = np.linspace(0, 4 * np.pi, 161)
    poses = np.stack([1.5 + 2.6 * np.cos(ang), 1.0 + 1.6 * np.sin(ang), ang + np.pi / 2], 1)
    ranges = _room_ranges(poses, beams)
    msgs = []
    for k in range(len(poses)):
        msgs.append(OdometryMessage(topic="/odom", timestamp=0.1 * k,
                                    pose=poses[k].astype(np.float32)))
        msgs.append(LaserMessage(topic="/scan", timestamp=0.1 * k, ranges=ranges[k],
                                 angle_min=-np.pi, angle_max=np.pi, range_min=0.0,
                                 range_max=30.0))
    cfg = dataclasses.replace(cfg, detector=dataclasses.replace(
        cfg.detector, relocalize_min_inliers=50))
    fk.launches = nk.launches = 0
    runner = ChunkedSlamRunner(slam_config=cfg, preprocessor_config=pcfg, chunk=64,
                               device=card)
    n = runner.run(iter(msgs))
    assert n == len(poses) and fk.launches == 3 and nk.launches >= 1
    traj = np.stack([q for _, q, _ in runner.trajectory])
    assert np.isfinite(traj).all()
    # two full laps end where they began, at the trajectory's origin
    assert np.abs(traj[-1, :2]).max() < 0.5
