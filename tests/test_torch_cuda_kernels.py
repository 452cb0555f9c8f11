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
1e-4 (chip_smoke.py holds the full-width shapes to 1e-3). The projector and
scene kernels do no sums: indices, rows and depths are EQUAL, fields agree
to 1e-6 (ties are averaged across the blocks of a cluster); the aligner
kernels' estimates agree to 1e-5, their counts to 1 (the multi-cue
aligner's, which sums twice the rows, to 2). The probes: the
shift z-buffer's winners and validity EQUAL and depths within 1e-6, also
with forced depth ties; the gather EQUAL (the same additions in the same
order) at K = 1, 8, 32 and at 256 lanes."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu_torch.bench.synthetic import tie_counts, with_tied_rows
from srrg2_laser_slam_2d_tpu_torch.models import fast_tracker as ft
from srrg2_laser_slam_2d_tpu_torch.models.preprocessor import (
    LaserModel, PreprocessorConfig, ScanPreprocessor)
from srrg2_laser_slam_2d_tpu_torch.models import tracker as tr
from srrg2_laser_slam_2d_tpu_torch.ops import _beam_kernels as bk
from srrg2_laser_slam_2d_tpu_torch.ops import banded_align_kernel as bak
from srrg2_laser_slam_2d_tpu_torch.ops import clip as clip_op
from srrg2_laser_slam_2d_tpu_torch.ops import frame_kernel as fk
from srrg2_laser_slam_2d_tpu_torch.ops import nn_icp_kernel as nk
from srrg2_laser_slam_2d_tpu_torch.ops import projective_align_kernel as pak
from srrg2_laser_slam_2d_tpu_torch.ops import projector as projector_op
from srrg2_laser_slam_2d_tpu_torch.ops import projector_kernel as pk
from srrg2_laser_slam_2d_tpu_torch.ops import scene_kernel as sck
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


def _projection(pre, cols: int):
    """The scans' own beam grid, or one of ``cols`` beams over the same
    angles and ranges."""
    if cols == pre.projection.cols:
        return pre.projection
    return projector_op.PolarProjection.make(cols=cols, angle_min=-np.pi, angle_max=np.pi,
                                             range_min=0.0, range_max=30.0)


@pytest.mark.parametrize("cols,window,raw", [(361, 256, False), (400, 256, True),
                                             (100, 128, False), (1000, 256, False)],
                         ids=["B384", "B512-raw", "B128", "B1024"])
def test_frame_kernel_matches_plain_on_card(card, cols, window, raw):
    """The chunk kernel against its plain version over 16 frames with a
    local-map split, at B = 384, 128 and 1024 and in the raw [T, F, 8]
    layout (at B = 512: off the scans' grid, so raw points do not sit on
    beam-bin edges); then frame_step (T = 1)."""
    T, beams = 16, 361
    poses = np.stack([np.linspace(-2.0, 0.5, T + 1), np.linspace(-1.0, 0.2, T + 1),
                      np.linspace(0.0, 0.4, T + 1)], 1)
    pcfg = PreprocessorConfig(voxelize_resolution=0.02, normal_window=8,
                              voxelize_mode="sequential")
    pre = ScanPreprocessor(pcfg, device=card)
    pre.set_model(LaserModel(beams, -np.pi, np.pi, 0.0, 30.0))
    clouds = pre.compute(_room_ranges(poses, beams))
    spec = fk.FrameSpec(projection=_projection(pre, cols), scene_capacity=2048, iterations=8,
                        window=window, split_distance=0.6, meas_as_canvas=not raw)
    assert spec.cols_padded == {100: 128, 361: 384, 400: 512, 1000: 1024}[cols]
    st = ft.seed(spec, clouds.map(lambda x: x[0]), np.zeros(3, np.float32),
                 odom=poses[0].astype(np.float32))
    odoms = torch.as_tensor(poses[1:], dtype=torch.float32, device=card)
    pack = ft.pack_measurement_batch if raw else functools.partial(
        ft.pack_measurement_canvas_batch, spec)
    measC = pack(clouds.map(lambda x: x[1:]), odoms)
    before = fk.launches
    kc, kp, kpay = fk.track_frames_grid(spec, st.cacheT, st.pose, measC)
    torch.cuda.synchronize()
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


def _room_streams(card, K: int, T: int, beams: int, spec_kw: dict, cols: int):
    """K different drives through the room, packed for the K-stream kernel:
    (spec, seed states, cacheB, poseB, measC_stack, odom_stack)."""
    pcfg = PreprocessorConfig(voxelize_resolution=0.02, normal_window=8,
                              voxelize_mode="sequential")
    pre = ScanPreprocessor(pcfg, device=card)
    pre.set_model(LaserModel(beams, -np.pi, np.pi, 0.0, 30.0))
    spec = fk.FrameSpec(projection=_projection(pre, cols), scene_capacity=2048, **spec_kw)
    states, meas, odoms = [], [], []
    for k in range(K):
        # five drive shapes, each mirrored and shifted as k grows
        u = np.linspace(0.0, 1.0, T + 1)
        m, sgn = k % 5, 1.0 - 2.0 * ((k // 5) % 2)
        poses = np.stack([-2.0 + (1.5 + 0.3 * m) * u + 0.01 * (k // 10),
                          sgn * (-1.0 + (0.2 * m) * u + 0.8 * u * u),
                          sgn * (0.3 - 0.15 * m) * u], 1)
        clouds = pre.compute(_room_ranges(poses, beams))
        states.append(ft.seed(spec, clouds.map(lambda x: x[0]), np.zeros(3, np.float32),
                              odom=poses[0].astype(np.float32)))
        meas.append(ft.pack_measurement_canvas_batch(spec, clouds.map(lambda x: x[1:])))
        odoms.append(torch.as_tensor(poses[1:], dtype=torch.float32, device=card))
    cacheB, poseB = sk.pack_stream_state(torch.stack([s.cacheT for s in states]),
                                         torch.stack([s.pose for s in states]))
    measC, odomS = sk.pack_stream_measurements(torch.stack(meas), torch.stack(odoms))
    return spec, states, cacheB, poseB, measC, odomS


@pytest.mark.parametrize("gather,refresh,iterations,K,cols", [
    ("onehot", 2, 7, 5, 361), ("roll", 1, 6, 5, 361), ("onehot", 1, 6, 5, 361),
    ("onehot", 2, 7, 133, 361), ("roll", 2, 6, 5, 100), ("onehot", 1, 6, 5, 1000)],
    ids=["onehot-2", "roll-1", "onehot-1", "onehot-2-K133", "roll-2-B128", "onehot-1-B1024"])
def test_stream_kernel_matches_plain_on_card(card, gather, refresh, iterations, K, cols):
    """K different streams against the plain version over 12 frames: both
    bands, corr_refresh 1 and 2, K = 133 (a second wave over the card's 132
    SMs), B = 128, 384 and 1024; then stream_step (T = 1)."""
    T = 12
    spec, states, cacheB, poseB, measC, odomS = _room_streams(
        card, K, T, 361, dict(iterations=iterations, window=128, stream_gather=gather,
                              corr_refresh=refresh), cols)
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


@pytest.mark.parametrize("threads", [64, 256, 352, 768, 1024])
def test_block_sums_are_bit_identical_across_warps_on_card(card, threads):
    """The frame step's reduction (block_sum13 of csrc/frame_common.cuh),
    which every thread of the frame kernels uses to solve for the pose: all
    threads, in every warp, hold the same 13 totals bit for bit, from either
    half of its double buffer; the totals agree with a float64 sum."""
    from srrg2_laser_slam_2d_tpu_torch.ops import _cuda

    rng = np.random.default_rng(threads)
    terms = (rng.normal(size=(threads, 13))
             * 10.0 ** rng.integers(-3, 4, (threads, 13))).astype(np.float32)
    out = torch.empty(2, threads, 13, device=card)
    err = _cuda.load("frame_kernel").frame_block_sum13(
        torch.from_numpy(terms).to(card).data_ptr(), out.data_ptr(), threads,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    o = out.cpu().numpy()
    bits = o.view(np.uint32)
    assert (bits == bits[:, :1]).all(), "threads disagree on the totals"
    # the second call sums twice the terms: exactly twice the totals
    np.testing.assert_array_equal(o[1, 0], 2.0 * o[0, 0])
    scale = np.abs(terms).astype(np.float64).sum(0)
    assert (np.abs(o[0, 0] - terms.astype(np.float64).sum(0)) <= 1e-5 * scale).all()


@pytest.mark.parametrize("cues,threads", [(1, 768), (2, 768), (2, 512), (4, 1024)])
def test_multicue_block_sums_are_bit_identical_across_warps_on_card(card, cues, threads):
    """The multi-cue aligner's reduction (csrc/multicue_align_kernel.cu:
    each cue's 13 sums per warp by warp_sums13, then multicue_totals, which
    the kernel's warp 0 calls): every warp that takes the totals gets the
    same 13 C totals bit for bit, twice over; they agree with a float64
    sum."""
    from srrg2_laser_slam_2d_tpu_torch.ops import _cuda

    rng = np.random.default_rng(cues * threads)
    terms = (rng.normal(size=(threads, cues, 13))
             * 10.0 ** rng.integers(-3, 4, (threads, cues, 13))).astype(np.float32)
    out = torch.empty(2, threads, cues, 13, device=card)
    err = _cuda.load("multicue_align_kernel").multicue_block_sums_test(
        torch.from_numpy(terms).to(card).data_ptr(), cues, out.data_ptr(), threads,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    o = out.cpu().numpy()
    bits = o.view(np.uint32)
    assert (bits == bits[:, :1]).all(), "threads disagree on the totals"
    np.testing.assert_array_equal(o[1, 0], 2.0 * o[0, 0])
    scale = np.abs(terms).astype(np.float64).sum(0)
    assert (np.abs(o[0, 0] - terms.astype(np.float64).sum(0)) <= 1e-5 * scale).all()


def _nn_pairs(rng, J: int, F: int, M: int):
    """J (fixed, moving) pairs of F and M points on six random walls; the
    moving points are the walls seen from a pose near the identity, with
    noise (the first min(F, M) wall points are shared)."""
    n = max(F, M)
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
    truth = np.concatenate([t, th[:, None]], 1)
    return p[:, :F], nrm[:, :F], mxy[:, :M], mn[:, :M], truth


def _nn_case(rng, case: str):
    """The fixed and moving clouds of a case and its pair count."""
    J = 8
    if case == "ragged":            # F = 1000 is not a multiple of the 512-point tile
        F, M = 1000, 1000
    elif case == "ragged-small":    # few moving points: many thread groups split F
        F, M = 700, 300
    else:
        F, M = (1536, 900) if case == "invalid-tile" else (1024, 1024)
    fxy, fn, mxy, mn, truth = _nn_pairs(rng, J, F, M)
    fvalid = rng.uniform(size=(J, F)) > 0.05
    mvalid = rng.uniform(size=(J, M)) > 0.05
    if case == "invalid-tile":
        fvalid[:, 512:1024] = False
        fxy[:, 512:1024] = rng.uniform(-50, 50, (J, 512, 2))   # never compared
    if case == "ties":
        # fixed points 256-383 repeat points 0-127 exactly (one tile, split
        # across thread groups: their distances tie) with normals turned by
        # up to 0.02 rad (the tie averages them); points 512-639 repeat them
        # in the next tile (a later tile's equal distance loses)
        fvalid[:] = True
        fxy[:, 256:384] = fxy[:, 0:128]
        fxy[:, 512:640] = fxy[:, 0:128]
        rot = rng.uniform(-0.02, 0.02, (J, 128))
        c, s = np.cos(rot), np.sin(rot)
        n0 = fn[:, 0:128]
        fn[:, 256:384] = np.stack([c * n0[..., 0] - s * n0[..., 1],
                                   s * n0[..., 0] + c * n0[..., 1]], -1)
    return J, fxy, fn, fvalid, mxy, mn, mvalid, truth


@pytest.mark.parametrize("case", ["ragged", "ragged-small", "invalid-tile", "ties"])
def test_nn_icp_kernel_matches_plain_on_card(card, case):
    rng = np.random.default_rng(3)
    J, fxy, fn, fvalid, mxy, mn, mvalid, truth = _nn_case(rng, case)
    F = fxy.shape[1]

    def cloud(xy, nm, v):
        return Cloud(torch.as_tensor(xy, dtype=torch.float32, device=card),
                     torch.as_tensor(nm, dtype=torch.float32, device=card),
                     torch.as_tensor(v, device=card))
    fixed = cloud(fxy, fn, fvalid)
    moving = cloud(mxy, mn, mvalid)
    init = torch.zeros(J, 3, device=card)
    kw = dict(iterations=30, max_distance=1.414, normal_cos=0.8, chi_threshold=0.05,
              min_inliers=10, corr_refresh=3)
    before = nk.launches
    got = nk.fused_align_pairs(fixed, moving, init, **kw)
    assert nk.launches == before + 1
    pad = -F % nk.TILE_F
    fixedP = torch.nn.functional.pad(nk.pack_fixed(fixed), (0, pad))   # F -> tiles
    fixedP[:, 5, F:] = 1e30                                           # padding never matches
    est, stats = nk.fused_align_pairs_plain(
        fixedP, nk.pack_moving(moving), init, 30, 1.414 ** 2, 0.8, 0.05, 10, 3)
    np.testing.assert_allclose(got.estimate.cpu().numpy(), est.cpu().numpy(), atol=1e-4)
    ref = stats.cpu().numpy()[:, 1:3]
    mine = np.stack([got.num_inliers.cpu().numpy(), got.num_correspondences.cpu().numpy()], 1)
    assert np.all(np.abs(mine - ref) <= 0.01 * np.maximum(ref, 1.0))
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


# ------------------------------------------------- the per-message kernels

def _random_cloud(card, seed: int, n: int) -> Cloud:
    rng = np.random.default_rng(seed)
    nm = rng.normal(size=(n, 2))
    nm /= np.linalg.norm(nm, axis=1, keepdims=True)
    return Cloud(torch.as_tensor(rng.uniform(-6, 6, (n, 2)), dtype=torch.float32, device=card),
                 torch.as_tensor(nm, dtype=torch.float32, device=card),
                 torch.as_tensor(rng.uniform(size=n) > 0.1, device=card))


def _with_ties(cloud: Cloud, proj, rows, depth: float, beam: int) -> Cloud:
    """``cloud`` with the given rows moved onto one beam at one depth; the
    other points of that beam up to 1 cm behind the tie are made invalid,
    so the tie holds the beam."""
    ang = (beam + 0.5 - proj.c) / proj.f
    xy, valid = cloud.xy.clone(), cloud.valid.clone()
    d, colf, _ = bk.beam_fields(xy[:, 0], xy[:, 1], valid, proj)
    valid &= ~((colf == beam) & (d <= depth + 0.01))
    for r in rows:
        xy[r] = torch.tensor([depth * np.cos(ang), depth * np.sin(ang)], dtype=torch.float32)
        valid[r] = True
    return Cloud(xy, cloud.normal, valid)


def _tie_rows(n: int) -> tuple:
    """Three rows of one tie: in three blocks of the cluster from 8,192
    points on, else spread over the cloud."""
    return (17, 5000, 8000) if n >= 8192 else (17, n // 2, n - 1)


@pytest.mark.parametrize("n,batch", [(768, 0), (1000, 0), (1024, 0), (1025, 0), (4096, 0),
                                     (8192, 0), (12288, 0), (20000, 0), (768, 1), (768, 4),
                                     (768, 16), (8192, 1), (8192, 4), (8192, 16)])
def test_projector_kernel_matches_plain_on_card(card, n, batch):
    """One block (N <= 1,024), a cluster (one point a thread), a cluster
    with two points a thread (12,288) and one with a second round of points
    (20,000); a batch of K clouds in ONE launch, each equal to the plain
    version; a tie at one depth on one beam, in three blocks of the cluster
    from 8,192 points on: the lowest row wins."""
    proj = projector_op.PolarProjection.make(cols=361, angle_min=-np.pi, angle_max=np.pi,
                                             range_min=0.3, range_max=20.0)
    clouds = [_with_ties(_random_cloud(card, 5 + j, n), proj, _tie_rows(n), 0.5, 100)
              for j in range(max(batch, 1))]
    xy = torch.stack([c.xy for c in clouds]) if batch else clouds[0].xy
    valid = torch.stack([c.valid for c in clouds]) if batch else clouds[0].valid
    before = pk.launches
    k = pk.project_local(proj, xy, valid)
    torch.cuda.synchronize()
    assert pk.launches == before + 1
    assert k.idx.dtype == torch.int64 and k.depth.shape == xy.shape[:-2] + (361,)
    for j, c in enumerate(clouds):
        kj = pk.Canvas(*(f[j] for f in k)) if batch else k
        p = pk.project_local_plain(proj, c.xy, c.valid)
        assert torch.equal(kj.idx, p.idx) and torch.equal(kj.valid, p.valid)
        assert torch.equal(kj.depth, p.depth) and int(kj.valid.sum()) > 200
        assert int(kj.idx[100]) == 17                 # the lowest index of the tie
    projector_op.ZBUFFER_BACKEND = "kernel"
    try:
        via_switch = projector_op.project_local(
            proj, Cloud(xy, torch.zeros_like(xy), valid))
    finally:
        projector_op.ZBUFFER_BACKEND = None
    assert torch.equal(via_switch.idx, k.idx) and pk.launches == before + 2


@pytest.mark.parametrize("n,chunk,ties", [(1000, 256, (17, 40, 900)),
                                          (4096, 1024, (17, 40, 900)),
                                          (8192, 1024, (17, 40, 900)),
                                          (8192, 4096, (1000, 1100, 5000)),
                                          (12288, 12288, (3000, 7000, 12000)),
                                          (20000, 4096, (16500, 16600, 17000))])
def test_scene_kernel_matches_plain_on_card(card, n, chunk, ties):
    """Rows and depths equal to the plain version, fields within 1e-6, on
    one block and on clusters. The first two tied rows share the winning
    chunk and are averaged: from 8,192 rows on they lie in different blocks
    of the cluster (12,288 rows: three rows in three blocks, two of them a
    thread's second row; 20,000 rows: three rows of the second round, which
    pass 2 computes again), so the tie's count and sums cross blocks."""
    proj = projector_op.PolarProjection.make(cols=361, angle_min=-np.pi, angle_max=np.pi,
                                             range_min=0.3, range_max=20.0)
    cam = torch.tensor([0.3, -0.2, 0.4], device=card)
    local = _with_ties(_random_cloud(card, 6, n), proj, ties, 0.5, 100)
    from srrg2_laser_slam_2d_tpu_torch.utils import cloud as cloud_op
    scene = cloud_op.transform(local, cam).map(lambda x: x.contiguous())
    before = sck.launches
    ko, kr = sck.canvas(proj, scene, cam, chunk=chunk)
    torch.cuda.synchronize()
    assert sck.launches == before + 1 and kr.dtype == torch.int64
    po, p_rows = sck.canvas_plain(proj, scene, cam, chunk=chunk)
    assert torch.equal(kr, p_rows) and torch.equal(ko[0], po[0]) and torch.equal(ko[5], po[5])
    np.testing.assert_allclose(ko.cpu().numpy(), po.cpu().numpy(), atol=1e-6)
    assert int((kr >= 0).sum()) > 200
    # the tie: the lowest row wins, the fields are the mean over the tied rows
    # of the winning chunk (camera-frame normals)
    assert int(kr[100]) == ties[0]
    same = [r for r in ties if r // chunk == ties[0] // chunk]
    assert len(same) >= 2
    c, s_ = torch.cos(cam[2]), torch.sin(cam[2])
    nm = scene.normal[list(same)]
    mean = torch.stack([c * nm[:, 0] + s_ * nm[:, 1], -s_ * nm[:, 0] + c * nm[:, 1]], 1).mean(0)
    np.testing.assert_allclose(ko[3:5, 100].cpu().numpy(), mean.cpu().numpy(), atol=1e-6)
    kclip = sck.clip_projective(proj, scene, torch.zeros(3, device=card), cam, chunk=chunk)
    assert kclip.capacity == 384 and sck.launches == before + 2


@pytest.fixture(scope="module")
def room_scans(card):
    """Six scans of a drive through the room at 361 beams, as clouds on the
    card, with the poses that serve as odometry."""
    T = 6
    poses = np.stack([np.linspace(-2.0, -1.0, T), np.linspace(-1.0, -0.5, T),
                      np.linspace(0.0, 0.15, T)], 1).astype(np.float32)
    pre = ScanPreprocessor(PreprocessorConfig(voxelize_resolution=0.02, normal_window=8),
                           device=card)
    pre.set_model(LaserModel(361, -np.pi, np.pi, 0.0, 30.0))
    clouds = pre.compute(_room_ranges(poses, 361))
    return [clouds.map(lambda x: x[k].contiguous()) for k in range(T)], poses


def _tracker_config(cols: int = 400, scene_capacity: int = 2048, **flags):
    # 400 beams against scans of 361: on the scans' own grid every point would
    # sit on a beam-bin edge, where the card's and the host's atan2 may differ
    proj = projector_op.PolarProjection.make(cols=cols, angle_min=-np.pi, angle_max=np.pi,
                                             range_min=0.3, range_max=20.0)
    return tr.TrackerConfig(scene_capacity=scene_capacity, projection=proj, **flags)


ALIGN_CASES = {
    "routes": {}, "ties": dict(ties=True), "beams128": dict(cols=128),
    "beams1024": dict(cols=1024), "all-invalid": dict(all_invalid=True),
    "iterations0": dict(iterations=0), "iterations128": dict(iterations=128),
    "no-prior": dict(odom_weight=0.0), "rows-past-threads": dict(triple_rows=True),
    "ball-clip": dict(ball=True)}
DENSE_ONLY = ("rows-past-threads", "ball-clip")


@pytest.mark.parametrize("banded, case", [(b, c) for b in (True, False) for c in ALIGN_CASES
                                          if not (b and c in DENSE_ONLY)],
                         ids=lambda v: v if isinstance(v, str) else ("banded" if v else "dense"))
def test_align_kernels_match_plain_on_card(card, room_scans, banded, case):
    """Both aligner kernels against their plain versions, held to
    ``chip_smoke.compare_align``'s tolerances: estimate within 1e-5, every
    pass's counts within 1, chi within rtol 1e-3. Cases: the routes'
    settings (400 beams, 10 iterations, odometry weight 1), forced two- and
    three-way depth ties, 128 and 1,024 beams, an all-invalid moving cloud,
    0 and 128 iterations, no odometry prior; the dense kernel also on three
    times the clip's rows (copies 1 cm off), more valid rows than threads,
    which it packs in chunks and reads from shared memory at each pass, and
    on the ball clipper's moving cloud, the whole 8,192-row scene, its rows
    in a seeded random order, so that valid rows lie both among the 4,096
    the kernel packs in shared memory and past them, where it reads them
    from global memory."""
    o = dict(dict(cols=400, ties=False, all_invalid=False, iterations=10, odom_weight=1.0,
                  triple_rows=False, ball=False), **ALIGN_CASES[case])
    clouds, poses = room_scans
    cfg = _tracker_config(o["cols"], 8192 if o["ball"] else 2048)
    st = tr.populate(cfg, tr.init_state(cfg, device=card), clouds[0])
    S = st.sensor_in_robot
    if banded:
        mod, fn, plain = bak, bak.fused_projective_align_banded, \
            bak.fused_projective_align_banded_plain
        clip = clip_op.clip_projective(cfg.projection, st.scene, st.robot_in_local_map, S)
    else:
        mod, fn, plain = pak, pak.fused_projective_align, pak.fused_projective_align_plain
        clip = sck.clip_projective(cfg.projection, st.scene, st.robot_in_local_map, S)
    if o["ball"]:
        clip = clip_op.clip_ball(st.scene, st.robot_in_local_map, S, cfg.ball_max_range)
        order = torch.randperm(8192, generator=torch.Generator().manual_seed(0)).to(card)
        clip = clip.map(lambda x: x[order])
        # packed rows fewer than the threads: global rows fill the rest of a pass's first round
        assert clip.capacity == 8192 and 0 < int(clip.valid[:4096].sum()) < 512
        assert int(clip.valid[4096:].sum()) > 0
    clip = clip.map(lambda x: x.contiguous())
    m = clouds[1]
    t0 = torch.tensor([-0.2, -0.1, -0.03], device=card)
    if o["ties"]:
        B = pk.cols_padded(cfg.projection)
        views = {"fixed": (cfg.projection, torch.zeros(3, device=card), B),
                 "moving": (cfg.projection, t0, B)}
        m = with_tied_rows(m, 1, view=views["fixed"])
        clip = with_tied_rows(clip, 2, beam_indexed=banded,
                              view=None if banded else views["moving"])
        assert {2, 3} <= tie_counts(m, views["fixed"])
        if not banded:
            assert {2, 3} <= tie_counts(clip, views["moving"])
    if o["all_invalid"]:
        clip = Cloud(clip.xy, clip.normal, torch.zeros_like(clip.valid))
    if o["triple_rows"]:
        clip = Cloud(torch.cat([clip.xy, clip.xy + 0.01, clip.xy - 0.01]),
                     torch.cat([clip.normal] * 3), torch.cat([clip.valid] * 3))
        assert int(clip.valid.sum()) > 512   # the dense kernel's threads at 400 beams
    args = (cfg.projection, m.xy, m.normal, m.valid, clip.xy, clip.normal, clip.valid, t0)
    its = o["iterations"]
    kw = dict(odom_prior=t0, iterations=its, chi_threshold=0.05, odom_weight=o["odom_weight"])
    before = mod.launches
    k = fn(*args, **kw)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    p = plain(*args, **kw)
    np.testing.assert_allclose(k.estimate.cpu().numpy(), p.estimate.cpu().numpy(), atol=1e-5)
    if o["all_invalid"]:
        assert float(p.num_corr) == float(k.num_corr) == 0.0
        np.testing.assert_allclose(k.estimate.cpu().numpy(), t0.cpu().numpy(), atol=1e-6)
    else:
        assert float(p.num_inliers) > (40 if o["cols"] == 128 else 100)
    assert abs(float(k.num_corr) - float(p.num_corr)) <= 1
    assert abs(float(k.num_inliers) - float(p.num_inliers)) <= 1
    np.testing.assert_allclose(float(k.chi), float(p.chi), rtol=1e-3)
    assert k.iter_stats.shape == (its, 4)
    if its:
        assert float((k.iter_stats[:, 1:3] - p.iter_stats[:, 1:3]).abs().max()) <= 1
        np.testing.assert_allclose(k.iter_stats[:, 0].cpu().numpy(),
                                   p.iter_stats[:, 0].cpu().numpy(), rtol=1e-3)
        # the inlier chi as compare_align holds it (relative to max(|plain|, 1e-3))
        inl_k, inl_p = k.iter_stats[:, 3], p.iter_stats[:, 3]
        assert float(((inl_k - inl_p).abs() / inl_p.abs().clamp(min=1e-3)).max()) <= 1e-3


@pytest.mark.parametrize("flags", [
    dict(use_fused_aligner=True, banded_aligner=True),
    dict(use_fused_aligner=True, banded_aligner=True, reuse_clip_canvas=True,
         lean_scene_ops=True),
    dict(use_fused_aligner=True, use_fused_scene_ops=True),
    dict(use_fused_aligner=True, use_fused_scene_ops=True, reuse_clip_canvas=True),
], ids=["banded", "banded-lean", "dense-scene-ops", "dense-scene-ops-reuse"])
def test_laser_tracker_on_card_follows_the_plain_versions(card, room_scans, flags):
    """The tracker over six scans: on the card every kernel of the route is
    launched; on the CPU the same code takes the plain versions. Poses agree
    to 1e-4 (block sums in another order; a flipped bin-edge cell would show
    as 1e-3)."""
    clouds, poses = room_scans
    cfg = _tracker_config(**flags)
    on_card = tr.LaserTracker(cfg, device=card)
    on_cpu = tr.LaserTracker(cfg, device="cpu")
    bak.launches = pak.launches = sck.launches = 0
    for k, c in enumerate(clouds):
        on_card.compute(c, poses[k])
        on_cpu.compute(c.to("cpu"), poses[k])
    steps = len(clouds) - 1
    assert on_card.steps == steps
    if flags.get("banded_aligner"):
        assert bak.launches == steps and pak.launches == 0
    else:
        assert pak.launches == steps and sck.launches == 3 * steps - on_card.cached_clips
    np.testing.assert_allclose(on_card.robot_in_local_map.cpu().numpy(),
                               on_cpu.robot_in_local_map.numpy(), atol=1e-4)
    assert np.linalg.norm(on_cpu.robot_in_local_map.numpy()[:2]) > 0.5
    # a cell on a bin edge may merge on one side and append on the other
    assert abs(int(on_card.capture_scene().count()) - int(on_cpu.capture_scene().count())) <= 4


MULTI_EXTR = np.array([[0.2, 0.0, 0.0], [-0.2, 0.0, np.pi]], np.float32)


@pytest.fixture(scope="module")
def dual_room_scans(card):
    """Six dual-laser packs of the room drive (front and rear laser, 361
    beams each) as cue-stacked clouds on the card, with the robot poses."""
    T = 6
    poses = np.stack([np.linspace(-2.0, -1.0, T), np.linspace(-1.0, -0.5, T),
                      np.linspace(0.0, 0.15, T)], 1).astype(np.float32)
    pre = ScanPreprocessor(PreprocessorConfig(voxelize_resolution=0.02, normal_window=8),
                           device=card)
    pre.set_model(LaserModel(361, -np.pi, np.pi, 0.0, 30.0))
    cues = []
    for e in MULTI_EXTR:
        c, s = np.cos(poses[:, 2]), np.sin(poses[:, 2])
        sensor = np.stack([poses[:, 0] + c * e[0] - s * e[1], poses[:, 1] + s * e[0] + c * e[1],
                           poses[:, 2] + e[2]], 1)
        cues.append(pre.compute(_room_ranges(sensor, 361)))
    packs = [Cloud(*(torch.stack([f[k] for f in fields]) for fields in zip(*cues)))
             for k in range(T)]
    return packs, poses


@pytest.mark.parametrize("cues", [2, 1, 4])
def test_multicue_align_kernel_matches_plain_on_card(card, dual_room_scans, cues):
    """Both lasers (C = 2), the front laser alone (C = 1), and both twice
    over (C = 4: every cue's system counted twice)."""
    from srrg2_laser_slam_2d_tpu_torch.ops import multicue_align_kernel as mak
    from srrg2_laser_slam_2d_tpu_torch.utils import cloud as cloud_op

    packs, poses = dual_room_scans
    cfg = _tracker_config()
    extr = torch.from_numpy(MULTI_EXTR).to(card)
    st = tr.populate_multi(cfg, tr.init_state(cfg, device=card), packs[0], extr)
    clips = [clip_op.clip_projective(cfg.projection, st.scene, st.robot_in_local_map, extr[c])
             for c in range(2)]
    mov = cloud_op.concat(*clips)
    t0 = torch.tensor([-0.2, -0.1, -0.03], device=card)
    order = {1: [0], 2: [0, 1], 4: [0, 1, 0, 1]}[cues]
    m = packs[1].map(lambda x: x[order])
    extr = extr[order]
    args = (cfg.projection, m.xy, m.normal, m.valid, extr, mov.xy, mov.normal, mov.valid, t0)
    for kw in (dict(odom_weight=1.0), dict(odom_weight=0.0, damping=5.0),
               dict(odom_weight=1.0, min_corr=100000)):
        kw = dict(kw, odom_prior=t0, iterations=10, chi_threshold=0.05)
        before = mak.launches
        k = mak.fused_projective_align_multi(*args, **kw)
        torch.cuda.synchronize()
        assert mak.launches == before + 1
        p = mak.fused_projective_align_multi_plain(*args, **kw)
        np.testing.assert_allclose(k.estimate.cpu().numpy(), p.estimate.cpu().numpy(),
                                   atol=1e-5)
        assert float(p.num_corr) > 200
        assert abs(float(k.num_corr) - float(p.num_corr)) <= 2
        assert abs(float(k.num_inliers) - float(p.num_inliers)) <= 2
        np.testing.assert_allclose(float(k.chi), float(p.chi), rtol=1e-3)
        assert float((k.iter_stats[:, 1:3] - p.iter_stats[:, 1:3]).abs().max()) <= 2
        if "min_corr" in kw:
            np.testing.assert_array_equal(k.estimate.cpu().numpy(), t0.cpu().numpy())


def test_multicue_tracker_on_card_follows_the_plain_version(card, dual_room_scans):
    """``MultiCueTracker`` with the kernel over six packs: one launch per
    tracked frame on the card, the plain version on the CPU; poses agree to
    2e-4 (block sums in another order over twice the rows)."""
    from srrg2_laser_slam_2d_tpu_torch.ops import multicue_align_kernel as mak

    packs, poses = dual_room_scans
    cfg = _tracker_config(use_fused_aligner=True)
    on_card = tr.MultiCueTracker(cfg, MULTI_EXTR, device=card)
    on_cpu = tr.MultiCueTracker(cfg, MULTI_EXTR, device="cpu")
    mak.launches = 0
    for k, c in enumerate(packs):
        on_card.compute(c, poses[k])
        on_cpu.compute(c.to("cpu"), poses[k])
    assert on_card.steps == len(packs) - 1 == mak.launches
    np.testing.assert_allclose(on_card.robot_in_local_map.cpu().numpy(),
                               on_cpu.robot_in_local_map.numpy(), atol=2e-4)
    assert np.linalg.norm(on_cpu.robot_in_local_map.numpy()[:2]) > 0.5


def test_probe_kernels_match_plain_on_card(card, room_scans):
    from srrg2_laser_slam_2d_tpu_torch.bench import exp_gather
    from srrg2_laser_slam_2d_tpu_torch.ops import beam_zbuffer_kernel as bzk
    from srrg2_laser_slam_2d_tpu_torch.utils import cloud as cloud_op

    clouds, _ = room_scans
    proj = projector_op.PolarProjection.make(cols=721, angle_min=-np.pi, angle_max=np.pi,
                                             range_min=0.3, range_max=20.0)
    canvas = projector_op.project_local(proj, clouds[0])
    idx = canvas.idx.clamp(min=0)
    cells = Cloud(clouds[0].xy[idx], clouds[0].normal[idx], canvas.valid)
    moved = cloud_op.transform(cells, torch.tensor([0.03, -0.02, 0.05], device=card))
    geoT = bzk.pack_cells(moved, proj)
    before = bzk.launches
    k = bzk.beam_zbuffer_probe(proj, geoT)
    torch.cuda.synchronize()
    assert bzk.launches == before + 1
    p = bzk.beam_zbuffer_probe_plain(proj, geoT)
    assert torch.equal(k[4], p[4]) and torch.equal(k[3], p[3]) and int(k[4].sum()) > 200
    assert float((k[:3] - p[:3]).abs().max()) <= 1e-6
    # forced two- and three-way depth ties at beams' minima: the highest lane wins
    B = bzk.cols_padded(proj)
    tied = bzk.pack_cells(with_tied_rows(moved, 0, True,
                                         view=(proj, torch.zeros(3, device=card), B)), proj)
    assert {2, 3} <= bzk.tie_counts(proj, tied)
    k, p = bzk.beam_zbuffer_probe(proj, tied), bzk.beam_zbuffer_probe_plain(proj, tied)
    assert torch.equal(k[4], p[4]) and torch.equal(k[3], p[3])
    assert float((k[:3] - p[:3]).abs().max()) <= 1e-6
    for K, lanes, shift in ((1, 768, 64), (8, 768, 64), (32, 768, 64), (2, 256, 16),
                            (8, 256, 16)):
        cv, ix = exp_gather.make_inputs(K, card, lanes, shift)
        ref = exp_gather.gather_probe_plain(cv, ix, 10)
        for form in exp_gather.FORMS:
            out = exp_gather.gather_probe(cv, ix, 10, form, shift)
            assert torch.equal(out, ref), (K, lanes, shift, form)
    with pytest.raises(ValueError):
        exp_gather.gather_probe(*exp_gather.make_inputs(1, card, 1028, 16), 10, "direct", 16)
    with pytest.raises(ValueError):
        exp_gather.gather_probe(*exp_gather.make_inputs(1, card, 254, 16), 10, "direct", 16)
    with pytest.raises(ValueError):
        exp_gather.gather_probe(cv, ix, 10, "take2d", shift)


def test_corridor_raycast_on_card_matches_numpy(card):
    """The batched torch ray cast of ``bench/synthetic.raycast_ranges`` on
    the card against the numpy loop on the host, over 48 poses of the
    corridor drive at 721 beams: the beams that hit in both agree to 1e-3 m
    (``cos``/``sin`` and the division round differently on the card), at
    most 0.1 % of the beams hit in one and miss in the other (a ray grazing
    a segment's end)."""
    from srrg2_laser_slam_2d_tpu_torch.bench import synthetic

    cfg = synthetic.CorridorConfig()
    _, seg_a, seg_b = synthetic.corridor_geometry(cfg)
    proj = projector_op.PolarProjection.make(cols=cfg.num_beams, angle_min=cfg.angle_min,
                                             angle_max=cfg.angle_max, range_min=cfg.range_min,
                                             range_max=cfg.range_max)
    poses = synthetic.corridor_trajectory(cfg)[::60][:48]
    on_card = synthetic.raycast_ranges(proj, poses, seg_a, seg_b, device=card)
    on_host = synthetic.raycast_ranges(proj, poses, seg_a, seg_b, device="cpu")
    both = (on_card > 0) & (on_host > 0)
    assert both.mean() > 0.5
    assert float(np.abs(on_card - on_host)[both].max()) <= 1e-3
    assert ((on_card > 0) != (on_host > 0)).mean() <= 1e-3


def test_prefetcher_waits_for_its_copies_on_card(card):
    """Items staged by ``io/prefetch.DevicePrefetcher`` on its side stream,
    read at once on the default stream: every one equals its source (the
    consumer's stream waits on the copy's event)."""
    from srrg2_laser_slam_2d_tpu_torch.io.prefetch import DevicePrefetcher

    n = 1 << 23                                    # 32 MiB an item
    items = [{"x": np.full(n, k, np.float32), "k": torch.full((4,), k)} for k in range(12)]
    for k, item in enumerate(DevicePrefetcher(iter(items), depth=3, device=card)):
        x = item["x"]
        assert x.device.type == "cuda" and item["k"].device.type == "cuda"
        total = (x - k).abs().sum()               # enqueued on the default stream
        assert float(total) == 0.0 and int(item["k"][0]) == k


def test_sharded_solvers_at_world_size_one_under_nccl(card, tmp_path):
    """``dist_pgo.optimize_sharded`` and ``schur.optimize_schur_sharded`` in
    a one-rank NCCL group on the card against ``pgo.optimize`` and
    ``optimize_schur`` on the same graphs (a correctness run of the
    collective path): poses to 1e-4 and 1e-3."""
    import torch.distributed as dist

    from srrg2_laser_slam_2d_tpu_torch.bench import pgo_bench
    from srrg2_laser_slam_2d_tpu_torch.parallel import dist_pgo, dryrun, multihost
    from srrg2_laser_slam_2d_tpu_torch.solver import pgo, schur

    dev = multihost.init_multiprocess(0, 1, "file://" + str(tmp_path / "rdv"), device=card)
    try:
        assert dist.get_backend() == "nccl"
        ring = dryrun.ring_graph(16, 32, np.random.default_rng(0), dev)
        cfg = pgo.PGOConfig(max_iterations=10)
        out, chi, _ = dist_pgo.optimize_sharded(cfg, dist_pgo.shard_edges(ring), None)
        ref, chi_ref, _ = pgo.optimize(cfg, ring)
        assert float((out.poses - ref.poses).abs().max()) <= 1e-4
        assert abs(float(chi) - float(chi_ref)) <= 1e-3 * max(float(chi_ref), 1e-3)
        grid = pgo_bench.make_grid_graph(16, device=dev)
        part = schur.partition_graph(grid, n_parts=8, n_vars=256)
        cfg = pgo.PGOConfig(max_iterations=3)
        out, _, _ = schur.optimize_schur_sharded(cfg, grid, part)
        ref, _, _ = schur.optimize_schur(cfg, grid, part)
        assert float((out.poses - ref.poses).abs().max()) <= 1e-3
    finally:
        dist.destroy_process_group()
