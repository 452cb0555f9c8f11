"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. print the card's name and power limit, build all three kernels from
     ``srrg2_laser_slam_2d_tpu_torch/csrc`` (one ``nvcc`` per source, all
     started together);
  2. the frame kernel against its plain PyTorch version on the card, on the
     first corridor chunk at the main path's shape (B = 768, T = 1024),
     local-map splits inside the chunk;
  3. the NN-ICP wrapper ``fused_align_pairs`` on the card against its plain
     version on the same packed inputs, at J = 128 pairs, F = M = 1024
     points, 30 iterations, correspondence refresh 3;
  4. the K-stream frame kernel ``track_streams_grid`` on the card against
     its plain version on the card at the throughput path's full width:
     K = 32 DIFFERENT synthetic streams (seeds 17 + k), T = 255 frames,
     B = 768, the ``stream_bench`` spec (``window=128``, ``corr_refresh=2``,
     ``onehot``); then the ``roll`` band and ``corr_refresh=1`` over the first
     ``STREAM_SHORT_T`` frames; and at ``corr_refresh=1`` each stream of the
     K-stream kernel against the single-stream CUDA kernel on that stream;
  5. the corridor run (2,871 frames, chunk 1024) through
     ``ChunkedSlamRunner`` under ``configurations/corridor.json`` and then
     ``configurations/corridor_lean.json``, each with the launch counters
     set to 0 just before and read just after;
  6. the throughput path through its entry points, the counters set to 0
     just before and read just after: ``stream_bench.measure_single``, then
     ``measure_streams`` at K = 8, 32 and 128 (10 chained calls, one
     synchronisation, best of 5; one kernel launch per chained call; then
     the kernel and the materialization of one call each alone), and
     the one-line headline of ``bench/headline.py`` at K = 32;
  7. one JSON line ``{"kernels": [...]}`` with each kernel's launches on its
     main path, its error against the plain version, its time, the plain
     version's time and its bound.
The last line is ``{"ok": true, "device": {...}}``. Longer output goes to
``chiprun_out/chip_smoke.json``. Nothing of the earlier paths is cut: the
whole script takes a few minutes of the card.

Tolerances. Kernel and plain version run the same float32 operations in
the same order (the CUDA sources are built without multiply-add
contraction); they differ in the order of the block sums and, for the
NN-ICP kernel, in how tied nearest neighbours are averaged. Those rounding
differences must stay below 1e-3 m / rad in poses and payload points. A
beam whose transformed cell sits exactly on a bin edge may change its merge
decision (kind or target row); from then on the two local maps hold
slightly different points until the next split. So the frame kernel is
held to its plain version in full (poses, payload points, every beam's kind
and target) up to the first frame where a merge decision differs, which
must lie at least ``FRAME_MIN_AGREE`` frames into the chunk; over the whole
chunk the split flags must be equal, the poses within 1e-3, 99.5 % of beams
must agree on kind and target, and the state after the chunk within 1e-3.
NN-ICP estimates agree within 1e-3, counts within 1 %. The K-stream kernel
has no split, so nothing resets a difference after a flipped decision, and
its inputs differ in the last bits from run to run (the voxel means of the
preprocessing are summed with atomics), so where the first flip falls
varies. It is therefore held to its plain version over EVERY frame of every
stream: the one launch over all T frames is compared up to the first frame
where some stream's decision differs; that stream-frame is flagged, the
kernel is launched again on the remaining frames from the plain version's
state there, and so on to the end. Outside the flagged stream-frames every
beam's kind and target and the appended count are equal and the estimates,
payload points and end states agree within 1e-3. A stream-frame is flagged
when a beam crosses a bin edge in the merge or a gate of the Gauss-Newton
loop by rounding; the latter moves that frame's estimate, and with it the
decisions of several beams. There the estimate and the points of the beams
whose decision agrees must still lie within ``FLAGGED_TOL`` (1e-2: readings
on the H100 reached 2e-3). Everywhere the stats lanes (chi,
correspondences and inliers of the last pass and of every iteration) agree
within rtol 1e-3 (+1e-4) but for at most 0.1 % of their entries (a single
beam crossing a gate by rounding), no count differing by more than 2; at
most 1 % of the stream-frames may be flagged, with at
most 16 beams' kinds differing in one. Against the single-stream CUDA kernel
(the same arithmetic, band and block sums) each stream's decisions are
equal and its points within 1e-6.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores
OUT_DIR = "chiprun_out"
FRAME_MIN_AGREE = 64
NN_CHECK_J = 128
CHUNK = 1024
STREAM_K = 32
STREAM_FRAMES = 256
STREAM_SHORT_T = 48
STREAM_KS = (8, 32, 128)
FLAGGED_TOL = 1e-2


def log(*args) -> None:
    print(*args, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` runs after one
    warm-up run (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 2

def corridor_chunk(msgs, n: int, pcfg, device):
    """The first ``n`` laser frames of the corridor log as clouds on the
    card, with the odometry each frame saw."""
    from srrg2_laser_slam_2d_tpu_torch.io.messages import LaserMessage, OdometryMessage
    from srrg2_laser_slam_2d_tpu_torch.models.preprocessor import LaserModel, ScanPreprocessor

    ranges, odoms, last, model = [], [], np.zeros(3, np.float32), None
    for m in msgs:
        if isinstance(m, OdometryMessage):
            last = np.asarray(m.pose, np.float32)
        elif isinstance(m, LaserMessage):
            model = LaserModel(len(m.ranges), m.angle_min, m.angle_max,
                               m.range_min, m.range_max)
            ranges.append(np.asarray(m.ranges, np.float32))
            odoms.append(last)
            if len(ranges) == n:
                break
    pre = ScanPreprocessor(pcfg, device=device)
    pre.set_model(model)
    return pre.compute(np.stack(ranges)), np.stack(odoms)


def check_frame_kernel(msgs, slam_cfg, pcfg, device) -> dict:
    import dataclasses

    from srrg2_laser_slam_2d_tpu_torch.models import fast_tracker as ft
    from srrg2_laser_slam_2d_tpu_torch.models.slam import frame_spec
    from srrg2_laser_slam_2d_tpu_torch.ops import frame_kernel as fk

    spec = dataclasses.replace(frame_spec(slam_cfg),
                               split_distance=slam_cfg.local_map_distance)
    B = spec.cols_padded
    clouds, odoms = corridor_chunk(msgs, CHUNK + 1, pcfg, device)
    st = ft.seed(spec, clouds.map(lambda x: x[0]), np.zeros(3, np.float32), odom=odoms[0])
    measC = ft.pack_measurement_canvas_batch(
        spec, clouds.map(lambda x: x[1:]), torch.from_numpy(odoms[1:]).to(device))
    T = measC.shape[0]

    kc, kp, kpay = fk.track_frames_grid(spec, st.cacheT, st.pose, measC)
    torch.cuda.synchronize()
    # the plain version takes tens of seconds for a chunk: one timed run
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    pc, pp, ppay = fk.track_frames_grid_plain(spec, st.cacheT, st.pose, measC)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    kpay, ppay = kpay.cpu().numpy(), ppay.cpu().numpy()
    kind_eq = kpay[:, 5] == ppay[:, 5]
    target_eq = kpay[:, 4] == ppay[:, 4]
    flips = np.flatnonzero(~(kind_eq & target_eq).all(axis=1))
    agree = int(flips[0]) if flips.size else T
    splits = int(ppay[:agree, 6, 7].sum())
    live = ppay[:agree, 5] > 0
    prefix_err = float(max(np.abs(kpay[:agree, r][live] - ppay[:agree, r][live]).max()
                           for r in range(4)))
    pose_err = float(max(np.abs(kpay[:, 6, 0:3] - ppay[:, 6, 0:3]).max(),
                         np.abs(kpay[:, 6, 8:11] - ppay[:, 6, 8:11]).max()))
    state_err = float(max(np.abs(kp.cpu().numpy() - pp.cpu().numpy()).max(),
                          np.abs(kc.cpu().numpy() - pc.cpu().numpy()).max()))
    err = max(prefix_err, pose_err, state_err)
    log(f"frame kernel T={T} B={B}: every merge decision agrees over the first "
        f"{agree} frames ({splits} splits), point err there {prefix_err:.3g}; "
        f"over the chunk: pose err {pose_err:.3g}, state err {state_err:.3g}, "
        f"kind agree {kind_eq.mean():.5f}, target agree {target_eq.mean():.5f}, "
        f"frames with a differing decision {flips.size}")
    assert agree >= FRAME_MIN_AGREE, f"a merge decision differs at frame {agree}"
    assert splits >= 1, "the fully compared frames must split a local map"
    assert np.array_equal(kpay[:, 6, 7], ppay[:, 6, 7]), "split frames differ"
    assert err <= 1e-3, f"frame kernel disagrees with its plain version: {err}"
    assert kind_eq.mean() >= 0.995 and target_eq.mean() >= 0.995

    ms = cuda_time_ms(lambda: fk.track_frames_grid(spec, st.cacheT, st.pose, measC), 5)
    # bound: what the function reads and writes, once each (canvas rows 0-5 and
    # the 4 odometry lanes in, 8 payload rows out, cache rows 0-5 and the pose
    # in, 8 cache rows and the pose out); operations counted from the frame
    # body (see csrc/frame_kernel.cu)
    bytes_moved = 4 * (T * ((6 + 8) * B + 4) + (6 + 8) * B + 2 * 16)
    flops = T * B * fk.flops_per_lane_frame(spec.iterations)
    b_ms, b_by = bound(bytes_moved, flops)
    log(f"frame kernel T={T}: {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "frame_kernel", "route": "cuda",
            "source": "srrg2_laser_slam_2d_tpu_torch/csrc/frame_kernel.cu",
            "replaces": "srrg2_laser_slam_2d_tpu/ops/pallas_frame.py:489",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": f"T={T} B={B} iterations={spec.iterations}",
            "frames_compared": agree, "splits_compared": splits}


# ------------------------------------------------------------------ phase 3

def synthetic_pairs(J: int, n: int, device, seed: int = 0):
    """J (fixed, moving) clouds of ``n`` points each: random walls with
    normals; moving = fixed seen from a perturbed pose, with noise and a few
    invalid points on both sides."""
    from srrg2_laser_slam_2d_tpu_torch.utils.cloud import Cloud

    rng = np.random.default_rng(seed)
    fxy = np.zeros((J, n, 2), np.float32)
    fn = np.zeros((J, n, 2), np.float32)
    truth = np.zeros((J, 3), np.float32)
    mxy = np.zeros_like(fxy)
    mn = np.zeros_like(fn)
    for j in range(J):
        a = rng.uniform(-8, 8, (8, 2))
        b = a + rng.uniform(-4, 4, (8, 2))
        seg = rng.integers(0, 8, n)
        u = rng.uniform(0, 1, (n, 1))
        p = a[seg] + u * (b[seg] - a[seg])
        d = (b - a)[seg]
        nrm = np.stack([-d[:, 1], d[:, 0]], 1) / np.linalg.norm(d, axis=1, keepdims=True)
        fxy[j], fn[j] = p, nrm
        t = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
                      rng.uniform(-0.08, 0.08)], np.float32)
        truth[j] = t
        c, s = np.cos(t[2]), np.sin(t[2])
        R = np.array([[c, -s], [s, c]])
        perm = rng.permutation(n)
        # moving-in-fixed pose t: fixed point = R m + t -> m = R^T (f - t)
        mxy[j] = ((p[perm] - t[:2]) @ R) + rng.normal(0, 0.005, (n, 2))
        mn[j] = nrm[perm] @ R
    fvalid = rng.uniform(size=(J, n)) > 0.03
    mvalid = rng.uniform(size=(J, n)) > 0.03
    dev = torch.device(device)

    def cloud(xy, nm, v):
        return Cloud(torch.from_numpy(xy).to(dev), torch.from_numpy(nm).to(dev),
                     torch.from_numpy(v).to(dev))
    return cloud(fxy, fn, fvalid), cloud(mxy, mn, mvalid), truth


def check_nn_icp_kernel(det_cfg, device) -> dict:
    from srrg2_laser_slam_2d_tpu_torch.ops import nn_icp_kernel as nk

    J, n = NN_CHECK_J, 1024
    acfg = det_cfg.aligner
    fixed, moving, _ = synthetic_pairs(J, n, device)
    initials = torch.zeros(J, 3, device=device)
    kw = dict(iterations=acfg.max_iterations, max_distance=acfg.point_distance,
              normal_cos=acfg.normal_cos, chi_threshold=acfg.chi_threshold,
              min_inliers=acfg.min_num_inliers, corr_refresh=det_cfg.fused_corr_refresh)
    kres = nk.fused_align_pairs(fixed, moving, initials, **kw)
    torch.cuda.synchronize()

    def plain():
        """The wrapper's packing and arguments, then the plain version."""
        return nk._result(*nk.fused_align_pairs_plain(
            nk.pack_fixed(fixed), nk.pack_moving(moving), initials, acfg.max_iterations,
            float(acfg.point_distance) ** 2, float(acfg.normal_cos),
            float(acfg.chi_threshold), int(acfg.min_num_inliers),
            int(det_cfg.fused_corr_refresh)))
    pres = plain()
    k = {f: v.cpu().numpy() for f, v in kres._asdict().items()}
    p = {f: v.cpu().numpy() for f, v in pres._asdict().items()}
    err = float(np.abs(k["estimate"] - p["estimate"]).max())
    cnt_rel = max(float((np.abs(k[f] - p[f]) / np.maximum(p[f], 1.0)).max())
                  for f in ("num_inliers", "num_correspondences"))
    chi_rel = max(float((np.abs(k[f] - p[f]) / np.maximum(np.abs(p[f]), 1e-6)).max())
                  for f in ("chi", "chi_inliers"))
    log(f"nn-icp kernel J={J} F=M={n}: max abs err {err:.3g}, "
        f"max count rel diff {cnt_rel:.4f}, max chi rel diff {chi_rel:.3g}, "
        f"mean inliers {p['num_inliers'].mean():.1f}")
    assert err <= 1e-3, f"NN-ICP kernel disagrees with its plain version: {err}"
    assert cnt_rel <= 0.01, f"NN-ICP counts differ by {cnt_rel}"

    ms = cuda_time_ms(lambda: nk.fused_align_pairs(fixed, moving, initials, **kw), 10)
    plain_ms = cuda_time_ms(plain, 2)
    # bound: every nearest-neighbour pass compares each valid moving point
    # with each valid fixed point (nk.FLOPS_PER_DISTANCE operations)
    passes = nk.nn_passes(acfg.max_iterations, det_cfg.fused_corr_refresh)
    pairs = (fixed.valid.sum(1).double() * moving.valid.sum(1).double()).sum().item()
    flops = passes * pairs * nk.FLOPS_PER_DISTANCE
    bytes_moved = 4 * (J * 6 * n + J * 5 * n + initials.numel() + J * 7)
    b_ms, b_by = bound(bytes_moved, flops)
    log(f"nn-icp kernel: {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "nn_icp_kernel", "route": "cuda",
            "source": "srrg2_laser_slam_2d_tpu_torch/csrc/nn_icp_kernel.cu",
            "replaces": "srrg2_laser_slam_2d_tpu/ops/pallas_icp.py:323",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": f"J={J} F=M={n} iterations={acfg.max_iterations} "
                     f"refresh={det_cfg.fused_corr_refresh}"}


# ------------------------------------------------------------------ phase 4

def plain_rollout(sk, spec, cacheB, poseB, measC, odomS):
    """The plain version frame by frame, keeping the state before every
    frame: (states [T + 1] of (cacheB, poseB), payloads [T, 8, K, B])."""
    states, pays = [(cacheB, poseB)], []
    for t in range(measC.shape[0]):
        c, p, pay = sk.track_streams_grid_plain(spec, *states[-1], measC[t:t + 1],
                                                odomS[t:t + 1])
        states.append((c, p))
        pays.append(pay[0])
    return states, torch.stack(pays)


def compare_streams(sk, spec, states, ppay, measC, odomS, label: str, first_out) -> float:
    """Hold the K-stream kernel against the plain rollout over every frame
    of every stream. ``first_out`` is the kernel's one launch over all T
    frames. Wherever some stream's merge decision differs, that stream and
    frame are flagged and the kernel is launched again on the remaining
    frames from the plain version's state there, so a bin-edge flip cannot
    hide what follows it. In a flagged stream-frame the estimate, the stats
    and the beams whose decision agrees are still compared, within
    ``FLAGGED_TOL``. Returns the largest error of the estimates, payload
    points and end states outside the flagged stream-frames."""
    T, _, K, B = ppay.shape
    its = spec.iterations
    t0 = err = err_flagged = flagged = worst_beams = windows = 0
    stats_off = stats_n = count_diff = 0
    stats_rel = 0.0
    while t0 < T:
        windows += 1
        assert windows <= 100, f"{label}: merge decisions keep differing"
        kc, kp, kpay = first_out if t0 == 0 else sk.track_streams_grid(
            spec, *states[t0], measC[t0:], odomS[t0:])
        pp = ppay[t0:]
        n = pp.shape[0]
        dec_eq = (kpay[:, 4] == pp[:, 4]) & (kpay[:, 5] == pp[:, 5])      # [n, K, B]
        same = dec_eq.all(-1)                                             # [n, K]
        fmin = n if bool(same.all()) else int((~same).any(1).float().argmax())
        if t0 == 0:
            first = torch.where(same.all(0), n, (~same).float().argmax(0)).cpu().numpy()
            run_pose = float((kpay[:, 6, :, 0:3] - pp[:, 6, :, 0:3]).abs().max())
            log(f"stream kernel {label} T={T} K={K}, the one launch left free: first "
                f"differing merge decision per stream min {int(first.min())}, streams with "
                f"none {int((first == n).sum())}/{K}; over the run kind agree "
                f"{(kpay[:, 5] == pp[:, 5]).float().mean():.5f}, target agree "
                f"{(kpay[:, 4] == pp[:, 4]).float().mean():.5f}, estimate err {run_pose:.3g}")
        upto = min(fmin + 1, n)
        kw, pw = kpay[:upto], pp[:upto]
        ok = same[:upto]                         # False only at frame fmin of a flagged stream
        live = (pw[:, 5] > 0) & dec_eq[:upto]
        pt = (kw[:, 0:4] - pw[:, 0:4]).abs().amax(1) * live                # [upto, K, B]
        both = torch.maximum(pt.amax(-1), (kw[:, 6, :, 0:3] - pw[:, 6, :, 0:3]).abs().amax(-1))
        err = max(err, float((both * ok).max()))
        err_flagged = max(err_flagged, float((both * ~ok).max()))
        # stats lanes: chi, correspondences and inliers of the last pass, chi
        # and inliers of every iteration (all taken before the merge)
        ks, ps = (torch.cat([x[:, 6, :, 3:6], x[:, 7, :, 0:its], x[:, 7, :, 64:64 + its]], -1)
                  for x in (kw, pw))
        diff = (ks - ps).abs()
        stats_off += int((diff > 1e-3 * ps.abs() + 1e-4).sum())
        stats_n += diff.numel()
        stats_rel = max(stats_rel, float((diff / ps.abs().clamp(min=1.0)).max()))
        counts = [1, 2] + list(range(3 + its, 3 + 2 * its))
        count_diff = max(count_diff, int(diff[..., counts].max()))
        assert torch.equal(kw[:, 6, :, 6][ok], pw[:, 6, :, 6][ok]), f"{label}: appended counts"
        if fmin < n:
            bad = ~same[fmin]
            flagged += int(bad.sum())
            worst_beams = max(worst_beams, int((kpay[fmin, 5] != pp[fmin, 5]).sum(-1).max()))
        else:
            # this launch ran to the end from an agreeing state: the end state
            # (a cell on a beam without a measurement can change beams unseen by
            # the payloads, so cache cells are compared where their rows agree)
            pc, pp_end = states[T]
            rows_eq = kc[5] == pc[5]
            err = max(err, float(((kc[0:4] - pc[0:4]).abs().amax(0) * rows_eq).max()),
                      float((kp - pp_end).abs().max()))
            assert rows_eq.float().mean() >= 0.995 and torch.equal(kp[:, 7], pp_end[:, 7])
        t0 += upto
    log(f"stream kernel {label}: every frame of every stream compared in {windows} launches; "
        f"stream-frames with a differing merge decision {flagged}/{K * T} "
        f"(at most {worst_beams} beams' kind in one), max abs err of estimate and "
        f"agreeing beams there {err_flagged:.3g}, max abs err elsewhere {err:.3g}; "
        f"stats entries outside rtol 1e-3 {stats_off}/{stats_n}, largest count "
        f"difference {count_diff}, largest stats difference (relative above 1) {stats_rel:.3g}")
    assert flagged <= 0.01 * K * T and worst_beams <= 16, label
    assert err <= 1e-3, f"{label}: stream kernel disagrees with its plain version: {err}"
    assert err_flagged <= FLAGGED_TOL, f"{label}: flagged stream-frames differ by {err_flagged}"
    assert stats_off <= 1e-3 * stats_n and count_diff <= 2, f"{label}: stats lanes differ"
    return err


def check_stream_kernel(device) -> dict:
    import dataclasses

    from srrg2_laser_slam_2d_tpu_torch.bench import stream_bench
    from srrg2_laser_slam_2d_tpu_torch.ops import frame_kernel as fk
    from srrg2_laser_slam_2d_tpu_torch.ops import stream_kernel as sk

    t0 = time.perf_counter()
    spec, states0, cacheB, poseB, measC, odomS = stream_bench.build_different_streams(
        STREAM_FRAMES, STREAM_K, device=device)
    T, _, K, B = measC.shape
    log(f"stream inputs: K={K} different streams, T={T}, B={B} "
        f"({time.perf_counter() - t0:.1f} s)")
    assert (T, K, B) == (STREAM_FRAMES - 1, STREAM_K, 768)
    first = odomS[0, :, 0:3]                                  # each stream's first step
    apart = (first[:, None] - first[None, :]).abs().amax(-1) + torch.eye(K, device=device)
    assert (apart > 1e-4).all(), "the streams must differ"

    # the full width: the stream_bench spec (onehot, window 128, refresh 2)
    kout = sk.track_streams_grid(spec, cacheB, poseB, measC, odomS)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    states, ppay = plain_rollout(sk, spec, cacheB, poseB, measC, odomS)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = compare_streams(sk, spec, states, ppay, measC, odomS, "onehot refresh 2", kout)
    assert all(bool(torch.isfinite(x).all()) for x in kout)
    # for the record: the odometry here is the exact trajectory (the circle of
    # the synthetic world does not pin the heading, so the tracker drifts)
    for name, pB in (("kernel", kout[1]), ("plain", states[T][1])):
        off = (pB[:, 0:3] - odomS[-1, :, 0:3]).abs().amax(0).cpu().numpy()
        log(f"stream {name} end poses against the ground truth: max |dx| {off[0]:.4f} m, "
            f"|dy| {off[1]:.4f} m, |dtheta| {off[2]:.4f} rad")

    # the other band and refresh 1, over the first frames
    mS, oS = measC[:STREAM_SHORT_T], odomS[:STREAM_SHORT_T]
    for label, sp in (("roll refresh 2", dataclasses.replace(spec, stream_gather="roll")),
                      ("onehot refresh 1", dataclasses.replace(spec, corr_refresh=1)),
                      ("roll refresh 1", dataclasses.replace(spec, stream_gather="roll",
                                                             corr_refresh=1))):
        k_short = sk.track_streams_grid(sp, cacheB, poseB, mS, oS)
        st_short, pay_short = plain_rollout(sk, sp, cacheB, poseB, mS, oS)
        err = max(err, compare_streams(sk, sp, st_short, pay_short, mS, oS, label, k_short))

    # refresh 1, onehot: each stream against the single-stream CUDA kernel
    spec1 = dataclasses.replace(spec, corr_refresh=1)
    _, kp1, kpay1 = sk.track_streams_grid(spec1, cacheB, poseB, mS, oS)
    single_err = 0.0
    for k in range(K):
        measF = mS[:, :, k].clone()
        measF[:, 6, 0:4] = oS[:, k, 0:4]
        _, sp_, spay = fk.track_frames_grid(spec1, states0[k].cacheT, states0[k].pose, measF)
        assert torch.equal(kpay1[:, 4:6, k], spay[:, 4:6]), f"stream {k}: decisions differ"
        single_err = max(single_err, float((kpay1[:, 0:4, k] - spay[:, 0:4]).abs().max()),
                         float((kp1[k, 0:8] - sp_[0]).abs().max()))
    log(f"stream kernel against the single-stream CUDA kernel, {K} streams, "
        f"T={STREAM_SHORT_T}: decisions equal, max abs err {single_err:.3g}")
    assert single_err <= 1e-6, single_err

    ms = cuda_time_ms(lambda: sk.track_streams_grid(spec, cacheB, poseB, measC, odomS), 5)
    # bound: what the function reads and writes, once each (canvas rows 0-5
    # and the odometry in, all 8 payload rows out, cache rows 0-5 and the pose in,
    # 8 cache rows and the pose out); operations counted from the frame body,
    # one gather per refresh
    bytes_moved = 4 * (T * (6 + 8) * K * B + T * K * 8 + (6 + 8) * K * B + 2 * K * 16)
    flops = T * K * B * sk.flops_per_lane_frame(spec.iterations, spec.corr_refresh)
    b_ms, b_by = bound(bytes_moved, flops)
    log(f"stream kernel K={K} T={T}: {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    return {"name": "stream_kernel", "route": "cuda",
            "source": "srrg2_laser_slam_2d_tpu_torch/csrc/stream_kernel.cu",
            "replaces": "srrg2_laser_slam_2d_tpu/ops/pallas_stream.py:732",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": f"K={K} T={T} B={B} iterations={spec.iterations} "
                     f"window={spec.window} refresh={spec.corr_refresh} {spec.stream_gather}",
            "err_vs_single_stream_kernel": single_err}


# ------------------------------------------------------------------ phase 5


def trajectory_rms_vs(runner, path: str) -> float:
    """RMS xy distance of the run's trajectory to a committed TUM file,
    matched by timestamp."""
    from srrg2_laser_slam_2d_tpu_torch.io import tum

    ref_t, ref_p = tum.read_tum(path)
    t = np.array([s for s, _, _ in runner.trajectory])
    p = np.stack([q for _, q, _ in runner.trajectory])
    idx = np.clip(np.searchsorted(ref_t, t - 1e-7), 0, len(ref_t) - 1)
    return float(np.sqrt(((p[:, :2] - ref_p[idx, :2]) ** 2).sum(1).mean()))


def corridor_run(cfg_path: str, msgs, device) -> tuple[dict, object]:
    from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e
    from srrg2_laser_slam_2d_tpu_torch.ops import frame_kernel, nn_icp_kernel

    frame_kernel.launches = 0
    nn_icp_kernel.launches = 0
    summary, runner = corridor_e2e.run_pass(cfg_path, CHUNK, None, device, msgs)
    torch.cuda.synchronize()
    summary["launches"] = {"frame_kernel": frame_kernel.launches,
                           "nn_icp_kernel": nn_icp_kernel.launches}
    traj = np.stack([p for _, p, _ in runner.trajectory])
    assert traj.shape == (summary["frames"], 3) and np.isfinite(traj).all()
    summary["rms_vs_tpu_run_m"] = trajectory_rms_vs(runner, "bench/results/corridor_r05.tum")
    log(f"corridor {cfg_path}: {json.dumps(summary)}")
    assert summary["frames"] == 2871
    assert summary["gate_verdict"] == "PASS", summary
    assert corridor_e2e.closures_accepted(summary), "no loop closure was accepted"
    assert summary["launches"]["frame_kernel"] > 0 and summary["launches"]["nn_icp_kernel"] > 0
    return summary, runner


# ------------------------------------------------------------------ phase 6

def headline_run(device) -> dict:
    """The throughput path through its entry points. The stream kernel's
    count is read over the K sweep (one launch per chained call, warm-up
    run included) and again over the headline."""
    from srrg2_laser_slam_2d_tpu_torch._device import card_description
    from srrg2_laser_slam_2d_tpu_torch.bench import headline, stream_bench
    from srrg2_laser_slam_2d_tpu_torch.ops import frame_kernel, stream_kernel

    reps = 5
    calls = (reps + 1) * stream_bench.CHAIN
    frame_kernel.launches = 0
    stream_kernel.launches = 0
    spec, state0, measC, odoms = stream_bench.build_inputs(STREAM_FRAMES, device=device)
    result = {"card": card_description(device), "num_beams": int(spec.projection.cols),
              "gn_iterations": spec.iterations,
              "single_stream": stream_bench.measure_single(spec, state0, measC, odoms,
                                                           reps=reps),
              "streams": []}
    assert frame_kernel.launches == calls and stream_kernel.launches == 0
    for k in STREAM_KS:
        before = stream_kernel.launches
        result["streams"].append(stream_bench.measure_streams(spec, state0, measC, odoms, k,
                                                              reps=reps, parts=True))
        # one launch per chained call, then the parts: one launch for their
        # inputs and the kernel alone, warm-up included
        assert stream_kernel.launches - before == calls + 1 + (reps + 1)
    log(json.dumps(result))
    sweep_launches = stream_kernel.launches

    stream_kernel.launches = 0
    line = headline.headline(device, reps=reps)
    log(json.dumps(line))
    assert line["mode"] == "k_stream" and line["streams"] == STREAM_K
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert stream_kernel.launches == calls
    return {"stream_bench": result, "headline": line,
            "launches": {"stream_kernel": stream_kernel.launches,
                         "stream_kernel_sweep": sweep_launches,
                         "frame_kernel_single_stream": frame_kernel.launches}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from srrg2_laser_slam_2d_tpu_torch import resolve_device
    from srrg2_laser_slam_2d_tpu_torch._device import card_description
    from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e
    from srrg2_laser_slam_2d_tpu_torch.ops import _cuda
    from srrg2_laser_slam_2d_tpu_torch.utils import config as config_mod

    t_start = time.perf_counter()
    device = resolve_device(None)
    card = card_description(device)
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda)

    t0 = time.perf_counter()
    logs = _cuda.build(force=True)
    log(f"built {', '.join(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    mgr = config_mod.ConfigManager.read("configurations/corridor.json")
    slam_cfg, pcfg = mgr.get_by_name("slam"), mgr.get_by_name("preprocessor")
    msgs = corridor_e2e.load_messages()
    stream_entry = check_stream_kernel(device)
    kernels = [check_frame_kernel(msgs, slam_cfg, pcfg, device),
               check_nn_icp_kernel(slam_cfg.detector, device), stream_entry]

    main_run, _ = corridor_run("configurations/corridor.json", msgs, device)
    lean_run, _ = corridor_run("configurations/corridor_lean.json", msgs, device)
    throughput = headline_run(device)
    launches = {**main_run["launches"], **throughput["launches"]}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        assert k["launches"] > 0, f"{k['name']} was not launched on its main path"

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "corridor": main_run,
                   "corridor_lean": lean_run, "throughput": throughput,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
