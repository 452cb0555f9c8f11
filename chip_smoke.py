"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. print the card's name and power limit, build all eleven kernels from
     ``srrg2_laser_slam_2d_tpu_torch/csrc`` (one ``nvcc`` per source, all
     started together);
  2. the frame kernel against its plain PyTorch version on the card, on the
     first corridor chunk at the main path's shape (B = 768, T = 1024),
     local-map splits inside the chunk, then on its first ``RAW_FRAMES``
     frames in the raw [T, F, 8] layout (the kernel z-buffers the rows
     itself); its time per chunk and per T = 1 launch (route D's);
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
     then the materialize kernel (``ops/materialize_kernel.py``, which
     replaces no TPU kernel) against its plain version on the card on the
     payloads of kernel 3 at the fleet's shapes (kernel 3 over 32 different
     streams, tiled out to K = 128 and cut to K = 8, T = 255, B = 768, cap
     4,096; each scene's payload rows 0-3, old scene and count offset by
     its index, so that no two scenes are alike; the payload handed in as a
     ``movedim`` view and the counts as ``pB[:, 7]``, as the fleet does):
     scenes EQUAL, inputs unchanged, one launch a call at K = 128 and two at
     K = 8, device ms of both and of the plain version beside the bytes
     bound;
  5. the four kernels of the per-message loop against their plain versions
     on the card, on real inputs: the first ``SCENE_FRAMES`` corridor frames
     tracked into one local map leave a scene of some 3,000 live points in
     8,192 rows; the projector kernel (N = 8,192 points, B = 768 beams; then
     a [16, 8,192] batch of views of the scene in ONE launch against 16
     plain calls) and the scene canvas kernel on that scene seen from the
     robot's pose and on the next scan from the identity (the merge's two
     canvases), each timed on the device and at the host's pace at N =
     8,192 and at the routes' shapes (the clip, the 1,024-row scan, batches
     of 1, 4 and 16 views), the
     banded and the dense aligner kernels on the next scan (1,024 rows)
     against the scene's clip (721 rows, and 768 from the canvas kernel)
     with the odometry step as initial guess and prior, 10 iterations;
  6. the corridor run (2,871 frames, chunk 1024) through
     ``ChunkedSlamRunner`` under ``configurations/corridor.json`` and then
     ``configurations/corridor_lean.json``, each with the launch counters
     set to 0 just before and read just after; the largest NN-ICP launch of
     the first run (one ``_detect_pool`` batch of the corridor's own scenes)
     is replayed against the plain version and timed, its bound counted
     from its own valid points; then the corridor once more with the loop
     detector on the default ``projective`` backend (batched projective ICP,
     no kernel), its gate, ATE and closures printed beside ``fused_nn``'s
     (informational: the gate decides for ``corridor.json`` as it is);
  7. the throughput path through its entry points, the counters set to 0
     just before and read just after: ``stream_bench.measure_single``, then
     ``measure_streams`` at K = 8, 32 and 128 (10 chained calls, one
     synchronisation, best of 5; one kernel launch per chained call; then
     the kernel and the materialization of one call each alone), and
     the one-line headline of ``bench/headline.py`` at K = 32; the
     materialize kernel's launches asserted over each (one a
     materialization at K = 128, two at K = 8 and 32 and for the single
     stream) and its calls printed by scenes x frames;
  8. the per-message loop, every launch counter set to 0 before each run and
     read after it: ``LaserTracker`` over ``ONE_MAP_SCANS`` corridor scans in
     one local map on routes A (banded aligner kernel), B (dense aligner and
     scene canvas kernels) and C (plain ICP), A and B held to C within
     0.01 m / 0.01 rad at every frame; ``SlamRunner`` over the first
     ``MESSAGE_FRAMES`` corridor frames on routes A, A with
     ``reuse_clip_canvas``, A with ``lean_scene_ops``, B, B with
     ``reuse_clip_canvas`` and C with the z-buffer backend set to the
     projector kernel, each with its launch counts asserted (one aligner
     launch per tracked frame; three canvas launches per tracked frame, two
     where the clip came from the cache; the projector kernel in every clip,
     aligner pass and merge) and its ATE held inside ``CORRIDOR_THRESHOLDS``,
     the calls of kernels 7 and 8 counted by shape (points, clouds);
     then route D (the default on a card: the frame kernel launched once per
     message) over the WHOLE corridor through ``generic_bench_app``'s
     function under ``corridor.json``: finite trajectory, a split, an
     accepted closure; the gate verdict is printed, not asserted;
  9. the MULTI path (two lasers and odometry) on a dual-laser log of the
     circle drive (``dual_drive``: 400 steps, 2 x 721 beams, front laser
     blanked over steps 100-159): the multi-cue aligner kernel against its
     plain version on a ``MultiCueTracker``'s scene after 10 packs (the
     clips of both cues, 2 x 721 rows, against the next pack); the two probe
     kernels against their plain versions (the shift z-buffer on 20 scans'
     cells and on cells with forced depth ties, the banded gather in both
     forms at K = 1, 8 and 32 and at 256 lanes), each beside the device time
     of an empty kernel at its launch shape, the gather at one pass also
     beside ``torch.gather``; the three
     rates of ``bench/multicue_bench`` (128 frames, one pass after the
     warm-up) with the kernel's share of a fused step; then the MULTI loop
     through ``SlamRunner(scan_topics=...)`` under ``multi_slam`` and the
     same log through the front laser alone under ``laser0_slam``, the
     kernel's launches counted from 0 and equal to the tracked frames, dual
     ATE <= single-cue ATE and a graph that closes;
  10. the reference's main entry point and what it reads and writes, every
     launch counter set to 0 before each run and read after it: (a) the
     whole corridor through ``apps/slam_app.py`` under ``corridor.json``
     with ``--chunked 1024``, the TUM trajectory (2,871 rows) and the map
     PNG written (its structure checked: signature, IDAT inflating to
     h * (1 + 3 w) bytes), the frame kernel launched 3 times and the NN-ICP
     kernel at least once, the gate PASS under ``CORRIDOR_THRESHOLDS`` with
     closures accepted, its ATE printed beside phase 6's; (b) a CARMEN log
     written by ``bench/synthetic.to_carmen`` from ``simulate`` at 721 beams
     and 400 steps, parsed by the native loader (built with ``g++`` into
     ``build/``, ``backend == "native"``) into arrays EQUAL to the Python
     parser's, then run per message through ``generic_bench_app --carmen``
     (route D: the frame kernel once per tracked frame, finite trajectory;
     the simul gate's verdict and ATE printed); (c) the same log with
     ``--checkpoint --checkpoint-every 100 --max-frames 200``, then resumed
     from the checkpoint: the frame kernel once per frame after the resume
     and the end pose within 0.3 m of (b)'s uninterrupted run, one save
     and one load timed alone; (d) the frame kernel's payload row 7
     (``FastTracker.iteration_stats``: chi and inliers per Gauss-Newton
     iteration) on one route-D frame of the log against its plain version
     from the same state, chi within 1e-3 relative, inliers equal; (e)
     ``slam_app -j`` writes the default assembly, which reads back equal;
  11. large pose graphs, the other finders and the idle share, every
     launch counter set to 0 before each corridor run and read after it:
     (a) the city-scale lattice of ``bench/pgo_bench`` through ``run`` at
     sides 256, 512 and 1,024 (1,048,576 nodes, 2,111,233 edges; sorted
     segment sums and chunked linearization above 100k nodes), 4 GN x 100
     CG iterations: chi before, after and per GN iteration, seconds per GN
     iteration, peak device memory; finite poses and chi reduced; the
     largest side once more with ``index_add_`` scatters beside it; (b) Schur
     on ``make_chain_graph(65536)`` at P = 512 and ``(262144)`` at P =
     1,024 (the separator-PCG branch), 3 GN iterations: chi per iteration,
     seconds per iteration; finite poses and every step inside the
     divergence guard's bound (the float32 elimination of chain interiors
     fails in the reference too: the guard stalls the solve or admits a
     step that raises chi, by the order of the atomic sums, so the larger
     chain is solved 4 more times and each outcome printed); 650
     partitions refused (the P % 256 rule); (c) Levenberg-Marquardt on
     tests/test_pgo.py's seeded circle: chi never rises, the solution
     within 1e-3 of the port's on the CPU; (d) the corridor through
     ``ChunkedSlamRunner`` under ``corridor.json`` with
     ``global_solver_kind`` "cg", then "schur" (in memory): the frame kernel
     launched 3 times, the NN-ICP kernel at least once, a solve reaching the
     solver, a finite trajectory; gate, ATE and closures printed beside
     phase 6's dense run (not asserted); (e) ``icp.align`` with the
     ``nn_grid`` and ``bruteforce`` finders on the corridor's first two
     scans on the card against the port on the CPU: estimates within 1e-4,
     the nearest field's indices equal; (f) the card's idle share
     (``profiling.device_trace`` / ``idle_share``), each in its own traced
     run after an untraced one whose wall is printed beside the traced
     window: the corridor chunked loop (dense), route D over 300 corridor
     frames, the MULTI loop over 100 steps, one GN iteration of (a)'s
     largest CG solve and of (b)'s largest Schur solve
     (``chiprun_out/idle_shares.json``);
  12. the last modules of the port, every launch counter set to 0 before
     each run and read after it: (a) ``bench/pipeline.track_sequence`` on
     routes A and B over the first 64 corridor frames from one populated
     state, against the same frames stepped one by one through
     ``track_step`` (within 1e-4), the banded / dense aligner kernel launched
     once a tracked frame (63); (b) ``bench/ablate --frames 64 --reps 1`` (its 25
     rows, each one call after a warm-up, one synchronisation, to
     ``chiprun_out/ablate.json``; kernels 1, 4 and 5 launched); (c) the whole
     corridor drive ray-cast on the card (2,871 poses, 1,024 beams, 9,836
     wall segments) against the numpy loop on every 64th pose: the largest
     range difference of the beams that hit in both (within 1e-3 m) and the
     count of beams whose hit/miss differs (at most 0.1 %); (d)
     ``synthetic_scene_generator --world corridors`` on the card, its log
     held against the committed ``bench/data/corridor.jsonl`` (the same
     tolerances over all 2,871 scans, the odometry within 1e-5); (e)
     ``corridor_report`` on phase 6's trajectory, ``visual_tests --stage
     all`` and ``param_reference`` (each PNG's structure checked, the
     markdown's size); (f) ``run_native_baseline`` (the C++ baseline built
     with ``g++`` into ``build/``) on the corridor: its wall, ATE and gate
     beside phase 6's run; (g) route D over the first 300 corridor frames
     with the ranges staged on the card by ``io/prefetch.DevicePrefetcher``
     against the same run fed from the host: the same graph counters, poses
     within 1e-6 m; then in a one-rank NCCL group (a correctness run of the
     collective path: one card measures no scaling) (h)
     ``dryrun_multichip(1)``, (i) ``optimize_sharded`` and
     ``optimize_schur_sharded`` against ``pgo.optimize`` and
     ``optimize_schur`` on the 4,096-node lattice (3 Gauss-Newton
     iterations; Schur at P = 64; poses within 1e-4 and 1e-3, with
     ``index_add_`` summing in a fixed order on both sides; the
     single-device solver's run-to-run spread under its default atomic
     sums printed beside), (j)
     ``parallel/scaling.main`` (one row a measurement; kernel 3 launched);
  13. the reference's BOSS assemblies (``tests/data/boss/``, written for the
     tests in its format) through ``io/boss_config.py``, every launch counter
     set to 0 before each run and read after it: (a) ``slam_app
     --boss-config`` with the LASER_0 document over the whole corridor with
     ``--chunked 1024`` (``ChunkedGraphSLAM2D`` forces the frame kernel):
     2,871 finite poses, the frame kernel launched 3 times; wall, ATE, the
     gate's verdict and whether closures were accepted printed beside phase
     6's run (the gate belongs to ``corridor.json``, not to this tuning, so
     it is not asserted); (b) the MULTI document through
     ``SlamRunner(scan_topics=...)`` over phase 9's dual drive: a
     ``MultiCueTracker``, the extrinsics from the TF tree within 1e-6, the
     multi-cue aligner kernel launched once a tracked frame, finite poses, a
     graph that closes; ATE beside phase 9's preset run; (c) ``slam_app
     --boss-config`` with the LASER_0 document per message over the first
     100 frames of phase 10's CARMEN log: the plain ICP tracker (route C
     under the default z-buffer), no kernel launched; frames/s printed;
  14. one JSON line ``{"kernels": [...]}`` with each of the eleven kernels'
     launches on its main path (the probes: their own probe runs; the
     materialize kernel: the corridor run's, with the throughput path's
     under ``throughput_launches`` and both paths' calls by scenes x frames
     under ``calls``), its error
     against the plain version, its time, the plain version's time, its
     bound and the time of one PyTorch call that computes the same function
     where there is one (the gather probe's ``torch.gather``).
The last line is ``{"ok": true, "device": {...}}``. Longer output goes to
``chiprun_out/chip_smoke.json`` (phase 10's launches of kernels 1 and 2 also
under ``slam_app_corridor_launches`` and ``carmen_per_message_launches`` of
their entries, phase 11's under ``corridor_cg_launches`` and
``corridor_schur_launches``, phase 12's under ``track_sequence_launches``,
``ablate_launches`` and ``scaling_launches``, phase 13's under
``boss_chunked_laser0_launches`` and ``boss_multi_launches``). One earlier
path runs at a smaller depth so that the whole stays inside its time limit:
phase 8's routes A, B and C over the first ``MESSAGE_FRAMES`` = 300
corridor frames. ``--only message-kernels`` / ``--only message-path`` /
``--only multi`` / ``--only slam-app`` / ``--only solvers`` / ``--only
port-rest`` / ``--only boss`` / ``--only materialize`` run the build and part
5, part 8, part 9, part 10, part 11, part 12 (with a corridor run of its
own), part 13 (with its own dual drive and CARMEN log) or the materialize
check of part 4 alone while developing, and print no result lines.
``bench/compare_csrc.py`` reuses the check functions to time every kernel
call this script times against other CUDA sources.

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
equal and its points within 1e-6. The projector and scene canvas kernels do
no sums: winner indices, rows and depths are EQUAL to the plain version's
and the fields agree within 1e-6 (a single winner is copied; two points tied
at a depth are averaged exactly). The aligner kernels' estimates agree
within 1e-5, the correspondence and inlier counts of every pass are equal
or 1 apart (a beam at a gate; 2 for the multi-cue aligner, which matches
twice the rows), chi within rtol 1e-3. The shift z-buffer probe's winners
are EQUAL and its depths within 1e-6, with and without forced ties; the
gather probe is EQUAL (the same additions in the same order), and at one
pass EQUAL to ``torch.gather``. The per-message, multi-cue and probe
kernels run for microseconds to tens of microseconds, less than the host takes to enqueue them, so
their ``ms`` is the device time with the queue kept full behind three large
matrix products (``device_time_ms``); ``host_paced_ms`` is the same calls at
the host's pace.
"""

from __future__ import annotations

import contextlib
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
RAW_FRAMES = 256
NN_CHECK_J = 128
CHUNK = 1024
STREAM_K = 32
STREAM_FRAMES = 256
STREAM_SHORT_T = 48
STREAM_KS = (8, 32, 128)
MATERIALIZE_KS = (128, 8)
FLAGGED_TOL = 1e-2
SCENE_FRAMES = 40
MESSAGE_FRAMES = 300
ONE_MAP_SCANS = 11


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


_SPIN = {}


def device_time_ms(fn, reps: int) -> float:
    """Mean DEVICE milliseconds of ``fn`` over ``reps`` runs, for kernels
    shorter than the host takes to enqueue them: the runs are enqueued while
    the card is still busy with three large matrix products, so they execute
    back to back and the host's pace does not show (``cuda_time_ms`` gives
    the host-paced time of the same calls)."""
    if "x" not in _SPIN:
        _SPIN["x"] = torch.randn(8192, 8192, device="cuda")
    x = _SPIN["x"]
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        x @ x
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    busy = not start.query()      # the products were still running when the last run was enqueued
    torch.cuda.synchronize()
    assert busy, "the host was too slow to keep the queue full; use more products"
    return start.elapsed_time(end) / reps


# every kernel timing of a run: label -> (method, function, repetitions), so
# that bench/compare_csrc.py can time the same calls again from other sources
KERNEL_TIMINGS: dict = {}


def kernel_time_ms(label: str, method, fn, reps: int) -> float:
    """``method(fn, reps)`` (``cuda_time_ms`` or ``device_time_ms``) of one
    kernel's wrapper call, kept under ``label`` in ``KERNEL_TIMINGS``."""
    KERNEL_TIMINGS[label] = (method, fn, reps)
    return method(fn, reps)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 2

def hold_frames(label: str, spec, st, meas, need_split: bool) -> tuple[float, int, int, float]:
    """The frame kernel against its plain version over one launch: every
    merge decision agrees over at least ``FRAME_MIN_AGREE`` frames (with a
    split among them where ``need_split``), the split flags are equal, the
    poses, the points of those frames and the end state within 1e-3, 99.5 %
    of kinds and targets equal. Returns (error, frames fully compared,
    splits among them, the plain version's milliseconds)."""
    from srrg2_laser_slam_2d_tpu_torch.ops import frame_kernel as fk

    T, B = meas.shape[0], spec.cols_padded
    kc, kp, kpay = fk.track_frames_grid(spec, st.cacheT, st.pose, meas)
    torch.cuda.synchronize()
    # the plain version takes tens of seconds for a chunk: one timed run
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    pc, pp, ppay = fk.track_frames_grid_plain(spec, st.cacheT, st.pose, meas)
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
    log(f"frame kernel {label} T={T} B={B}: every merge decision agrees over the first "
        f"{agree} frames ({splits} splits), point err there {prefix_err:.3g}; "
        f"over the launch: pose err {pose_err:.3g}, state err {state_err:.3g}, "
        f"kind agree {kind_eq.mean():.5f}, target agree {target_eq.mean():.5f}, "
        f"frames with a differing decision {flips.size}, plain {plain_ms:.1f} ms")
    assert agree >= FRAME_MIN_AGREE, f"{label}: a merge decision differs at frame {agree}"
    assert splits >= 1 or not need_split, "the fully compared frames must split a local map"
    assert np.array_equal(kpay[:, 6, 7], ppay[:, 6, 7]), f"{label}: split frames differ"
    assert err <= 1e-3, f"{label}: frame kernel disagrees with its plain version: {err}"
    assert kind_eq.mean() >= 0.995 and target_eq.mean() >= 0.995, label
    return err, agree, splits, plain_ms


def check_frame_kernel(msgs, slam_cfg, pcfg, device) -> dict:
    import dataclasses

    from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e
    from srrg2_laser_slam_2d_tpu_torch.models import fast_tracker as ft
    from srrg2_laser_slam_2d_tpu_torch.models.slam import frame_spec
    from srrg2_laser_slam_2d_tpu_torch.ops import frame_kernel as fk

    spec = dataclasses.replace(frame_spec(slam_cfg),
                               split_distance=slam_cfg.local_map_distance)
    B = spec.cols_padded
    clouds, odoms = corridor_e2e.first_frames(msgs, CHUNK + 1, pcfg, device)
    st = ft.seed(spec, clouds.map(lambda x: x[0]), np.zeros(3, np.float32), odom=odoms[0])
    measC = ft.pack_measurement_canvas_batch(
        spec, clouds.map(lambda x: x[1:]), torch.from_numpy(odoms[1:]).to(device))
    T = measC.shape[0]
    err, agree, splits, plain_ms = hold_frames("canvas layout", spec, st, measC, True)

    # the raw [T, F, 8] layout (meas_as_canvas=False): the kernel z-buffers
    # each frame's rows itself
    raw = dataclasses.replace(spec, meas_as_canvas=False)
    measF = ft.pack_measurement_batch(clouds.map(lambda x: x[1:RAW_FRAMES + 1]),
                                      torch.from_numpy(odoms[1:RAW_FRAMES + 1]).to(device))
    raw_err, raw_agree, _, raw_plain_ms = hold_frames("raw layout", raw, st, measF, False)
    raw_ms = kernel_time_ms("frame_kernel raw layout", cuda_time_ms,
                            lambda: fk.track_frames_grid(raw, st.cacheT, st.pose, measF), 5)

    ms = kernel_time_ms("frame_kernel", cuda_time_ms,
                        lambda: fk.track_frames_grid(spec, st.cacheT, st.pose, measC), 5)
    # one frame a launch, as the per-message loop (route D) launches it
    m0 = measC[0].contiguous()
    t1_ms = kernel_time_ms("frame_kernel T=1", device_time_ms,
                           lambda: fk.frame_step(spec, m0, st.cacheT, st.pose), 200)
    t1_paced_ms = cuda_time_ms(lambda: fk.frame_step(spec, m0, st.cacheT, st.pose), 200)
    # bound: what the function reads and writes, once each (canvas rows 0-5 and
    # the 4 odometry lanes in, 8 payload rows out, cache rows 0-5 and the pose
    # in, 8 cache rows and the pose out); operations counted from the frame
    # body (see csrc/frame_kernel.cu)
    bytes_moved = 4 * (T * ((6 + 8) * B + 4) + (6 + 8) * B + 2 * 16)
    flops = T * B * fk.flops_per_lane_frame(spec.iterations)
    b_ms, b_by = bound(bytes_moved, flops)
    log(f"frame kernel T={T}: {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"T=1: {t1_ms:.4f} ms ({t1_paced_ms:.4f} at the host's pace); raw layout "
        f"T={RAW_FRAMES} F={measF.shape[1]}: {raw_ms:.3f} ms, plain {raw_plain_ms:.1f} ms")
    return {"name": "frame_kernel", "route": "cuda",
            "source": "srrg2_laser_slam_2d_tpu_torch/csrc/frame_kernel.cu",
            "replaces": "srrg2_laser_slam_2d_tpu/ops/pallas_frame.py:489",
            "max_abs_err": max(err, raw_err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": f"T={T} B={B} iterations={spec.iterations}",
            "frames_compared": agree, "splits_compared": splits,
            "t1_ms": t1_ms, "t1_host_paced_ms": t1_paced_ms,
            "raw": {"frames": RAW_FRAMES, "rows": int(measF.shape[1]), "ms": raw_ms,
                    "plain_ms": raw_plain_ms, "max_abs_err": raw_err,
                    "frames_compared": raw_agree}}


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

    ms = kernel_time_ms("nn_icp_kernel", cuda_time_ms,
                        lambda: nk.fused_align_pairs(fixed, moving, initials, **kw), 10)
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


class DetectionCapture:
    """While the main path runs, keeps a copy of the inputs of the NN-ICP
    wrapper's largest call (the most pairs; the first of equals): one
    ``_detect_pool`` batch of the corridor's own scenes."""

    def __enter__(self):
        from srrg2_laser_slam_2d_tpu_torch.ops import nn_icp_kernel as nk

        self.batch, self._nk, self._fn = None, nk, nk.fused_align_pairs

        def wrapped(fixed, moving, initials, **kw):
            if self.batch is None or fixed.xy.shape[0] > self.batch[0].xy.shape[0]:
                self.batch = (fixed.map(torch.clone), moving.map(torch.clone),
                              initials.clone(), dict(kw))
            return self._fn(fixed, moving, initials, **kw)
        nk.fused_align_pairs = wrapped
        return self

    def __exit__(self, *exc):
        self._nk.fused_align_pairs = self._fn


def check_nn_icp_corridor(batch) -> dict:
    """Kernel 2 on a detection batch of the corridor run, replayed: its
    time, its bound from the batch's own valid points, and its agreement
    with the plain version. Some corridor pairs are ill-conditioned (a
    corridor leaves the translation along it nearly free): there the plain
    version's OWN estimate moves by up to some 7e-2 when only the order of
    its sums changes. So the plain version is also run with the moving
    points in 64 other orders (reversed, 63 permutations from seed 0), and
    each pair's spread is how far its plain estimate moves over them; the
    kernel's sum order is one more such order. Some pairs are bistable:
    most orders land on one branch and a few percent on another 2e-3 to
    5e-3 away, so the orders must be many enough to find the rarer branch
    (``bench/corridor_orders.py`` counts the corridor batches this check
    fails with 16 to 256 orders). Held: the estimate of every
    pair whose spread is within the 1e-3 limit, to max(1e-3, 2 x spread);
    every pair's counts within 1 %; at least seven eighths of the pairs
    held (a pair whose spread exceeds the limit bifurcates under
    reordering, and its estimate is not held)."""
    from srrg2_laser_slam_2d_tpu_torch.ops import nn_icp_kernel as nk

    fixed, moving, initials, kw = batch
    J, F = fixed.xy.shape[:2]
    M = moving.xy.shape[1]
    k = nk.fused_align_pairs(fixed, moving, initials, **kw)
    torch.cuda.synchronize()

    def plain(mov=moving):
        return nk._result(*nk.fused_align_pairs_plain(
            nk.pack_fixed(fixed), nk.pack_moving(mov), initials, kw["iterations"],
            float(kw["max_distance"]) ** 2, float(kw["normal_cos"]),
            float(kw["chi_threshold"]), int(kw["min_inliers"]), int(kw["corr_refresh"])))
    p = plain()
    gen = torch.Generator().manual_seed(0)
    orders = [torch.arange(M - 1, -1, -1)] + [torch.randperm(M, generator=gen) for _ in range(63)]
    spread = torch.zeros(J, device=p.estimate.device)
    for order in orders:
        o = order.to(p.estimate.device)
        q = plain(moving.map(lambda x: x[:, o]))
        spread = torch.maximum(spread, (q.estimate - p.estimate).abs().amax(1))
    pair_err = (k.estimate - p.estimate).abs().amax(1)
    held = spread <= 1e-3
    limit = torch.clamp(2 * spread, min=1e-3)
    err = float(pair_err[held].max()) if bool(held.any()) else 0.0
    excess = float((pair_err - limit)[held].max()) if bool(held.any()) else 0.0
    cnt_rel = max(float(((getattr(k, f) - getattr(p, f)).abs()
                         / getattr(p, f).clamp(min=1.0)).max())
                  for f in ("num_inliers", "num_correspondences"))
    ms = kernel_time_ms("nn_icp_kernel corridor batch", cuda_time_ms,
                        lambda: nk.fused_align_pairs(fixed, moving, initials, **kw), 10)
    plain_ms = cuda_time_ms(plain, 2)
    fv, mv = fixed.valid.sum(1).double(), moving.valid.sum(1).double()
    passes = nk.nn_passes(kw["iterations"], kw["corr_refresh"])
    flops = passes * float((fv * mv).sum()) * nk.FLOPS_PER_DISTANCE
    b_ms, b_by = bound(4 * (J * 6 * F + J * 5 * M + 3 * J + 7 * J), flops)
    out = {"J": J, "F": F, "M": M, "mean_valid_fixed": float(fv.mean()),
           "mean_valid_moving": float(mv.mean()), "max_abs_err": err,
           "max_abs_err_all_pairs": float(pair_err.max()), "pairs_held": int(held.sum()),
           "pairs_spread_above_1e-5": int((spread > 1e-5).sum()),
           "max_plain_spread": float(spread.max()), "max_count_rel_diff": cnt_rel, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
    log(f"nn-icp kernel on a corridor detection batch: {json.dumps(out)}; pairs whose plain "
        "spread exceeds 1e-5 (pair, kernel err, plain spread): " + ", ".join(
            f"({j}, {float(pair_err[j]):.3g}, {float(spread[j]):.3g})"
            for j in torch.nonzero(spread > 1e-5).flatten().tolist()))
    assert excess <= 0.0, ("NN-ICP kernel disagrees with its plain version beyond "
                           f"max(1e-3, 2 x spread): by {excess} more")
    assert cnt_rel <= 0.01, f"NN-ICP counts differ by {cnt_rel}"
    assert int(held.sum()) >= J - J // 8, f"only {int(held.sum())} of {J} pairs held"
    return out


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

    ms = kernel_time_ms("stream_kernel", cuda_time_ms,
                        lambda: sk.track_streams_grid(spec, cacheB, poseB, measC, odomS), 5)
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


def check_materialize_kernel(device) -> dict:
    """The materialize kernel against its plain version on kernel 3's
    payloads at the fleet's shapes, every scene its own (see the module
    docstring, part 4)."""
    from srrg2_laser_slam_2d_tpu_torch.bench import stream_bench
    from srrg2_laser_slam_2d_tpu_torch.models import fast_tracker as ft
    from srrg2_laser_slam_2d_tpu_torch.ops import materialize_kernel as mk
    from srrg2_laser_slam_2d_tpu_torch.ops import stream_kernel as sk
    from srrg2_laser_slam_2d_tpu_torch.utils.cloud import Cloud

    spec, states0, cacheB, poseB, measC, odomS = stream_bench.build_different_streams(
        STREAM_FRAMES, STREAM_K, device=device)
    _, pB0, pay0 = sk.track_streams_grid(spec, cacheB, poseB, measC, odomS)
    T, _, K0, B = pay0.shape
    cap = spec.scene_capacity
    xy0 = torch.stack([s.scene.xy for s in states0])
    nm0 = torch.stack([s.scene.normal for s in states0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows, err = {}, 0.0
    for K in MATERIALIZE_KS:
        # the K0 different streams tiled out to K; payload rows 0-3, the old
        # scene and the count offset by the scene's index, so that no two
        # scenes' inputs or results are alike (rows 4 and 5 are kernel 3's)
        tiles = -(-K // K0)
        off = torch.arange(K, device=device, dtype=torch.float32)
        payB = pay0.repeat(1, 1, tiles, 1)[:, :, :K].clone()
        payB[:, 0:4] += off[:, None]
        pB = pB0.repeat(tiles, 1)[:K].clone()
        pB[:, 7] = (pB[:, 7] - off).clamp(min=0.0)
        scene = Cloud(xy0.repeat(tiles, 1, 1)[:K] + off[:, None, None],
                      nm0.repeat(tiles, 1, 1)[:K] - off[:, None, None],
                      torch.zeros((K, cap), dtype=torch.bool, device=device))
        args = (spec, scene, payB.movedim(2, 0), pB[:, 7])
        inputs = [x.clone() for x in (payB, pB, scene.xy, scene.normal)]
        before = mk.launches
        got = ft.materialize(*args)
        torch.cuda.synchronize()
        launched = mk.launches - before
        want = mk.materialize_plain(*args)
        for name in ("xy", "normal", "valid"):
            assert torch.equal(getattr(got, name), getattr(want, name)), (K, name)
            err = max(err, float((getattr(got, name).float()
                                  - getattr(want, name).float()).abs().max()))
        assert all(torch.equal(a, b) for a, b in
                   zip(inputs, (payB, pB, scene.xy, scene.normal))), "inputs written"
        assert launched == (1 if 2 * K >= sms else 2), (K, sms, launched)
        live = int((payB[:, 5] > 0).sum())
        ms = kernel_time_ms(f"materialize_kernel K={K}", device_time_ms,
                            lambda: mk.materialize(*args), 50)
        plain_ms = device_time_ms(lambda: mk.materialize_plain(*args), 10)
        # bytes: rows 4 and 5 of every lane read once; a scene row's 16 bytes
        # read once (the winner's payload rows 0-3 or the old scene), its 16
        # written with its valid byte
        bytes_moved = K * T * B * 8 + K * cap * (16 + 16 + 1)
        b_ms, b_by = bound(bytes_moved, 0.0)
        log(f"materialize kernel K={K} ({K0} different streams tiled) T={T} B={B} cap={cap}: "
            f"{ms:.4f} ms ({launched} launches), plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
            f"({b_by}); scenes equal, {live} live lanes, "
            f"{int(got.valid.sum())} valid rows")
        rows[K] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "launches_per_call": launched,
                   "shape": f"K={K} T={T} B={B} cap={cap}"}
    main = rows[MATERIALIZE_KS[0]]
    return {"name": "materialize_kernel", "route": "cuda",
            "source": "srrg2_laser_slam_2d_tpu_torch/csrc/materialize_kernel.cu",
            "replaces": "none: srrg2_laser_slam_2d_tpu/models/fast_tracker.py:materialize "
                        "is XLA code",
            "max_abs_err": err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "shape": main["shape"],
            "by_k": rows}


# ------------------------------------------------- the per-message kernels

def tracked_scene(msgs, slam_cfg, pcfg, device):
    """Real inputs for the four per-message kernels: the first
    ``SCENE_FRAMES`` corridor frames tracked into ONE local map by the frame
    kernel (no split), which leaves a scene of a few thousand live points in
    8,192 rows and the robot's pose in it; then the next measurement with
    the odometry step that leads to it."""
    from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e
    from srrg2_laser_slam_2d_tpu_torch.models import fast_tracker as ft
    from srrg2_laser_slam_2d_tpu_torch.models.slam import frame_spec
    from srrg2_laser_slam_2d_tpu_torch.utils import geometry

    spec = frame_spec(slam_cfg)
    clouds, odoms = corridor_e2e.first_frames(msgs, SCENE_FRAMES + 1, pcfg, device)
    S = torch.zeros(3, device=device)
    st = ft.seed(spec, clouds.map(lambda x: x[0]), np.zeros(3, np.float32), odom=odoms[0])
    measC = ft.pack_measurement_canvas_batch(
        spec, clouds.map(lambda x: x[1:SCENE_FRAMES]),
        torch.from_numpy(odoms[1:SCENE_FRAMES]).to(device))
    st, _ = ft.track_sequence_fast(spec, st, measC)
    X = st.pose[0, 0:3].clone()
    meas = clouds.map(lambda x: x[SCENE_FRAMES].contiguous())
    od = torch.from_numpy(odoms).to(device)
    D = geometry.relative(od[SCENE_FRAMES - 1], od[SCENE_FRAMES])
    T0 = geometry.inverse(geometry.compose(D, S))
    live = int(st.scene.count())
    log(f"scene for the kernel checks: {live} live points in {st.scene.capacity} rows after "
        f"{SCENE_FRAMES} corridor frames, robot at {X.cpu().numpy().round(3).tolist()}")
    assert 2000 <= live <= st.scene.capacity
    return st.scene, X, S, meas, T0


def entry(name, source, replaces, err, ms, plain_ms, bytes_moved, flops, shape, **extra) -> dict:
    b_ms, b_by = bound(bytes_moved, flops)
    paced = f" ({extra['host_paced_ms']:.4f} ms at the host's pace)" if "host_paced_ms" in extra \
        else ""
    log(f"{name} {shape}: {ms:.4f} ms{paced}, plain {plain_ms:.3f} ms, "
        f"bound {b_ms:.6f} ms ({b_by})")
    return {"name": name, "route": "cuda",
            "source": f"srrg2_laser_slam_2d_tpu_torch/csrc/{source}",
            "replaces": f"srrg2_laser_slam_2d_tpu/ops/{replaces}", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": shape, **extra}


def timed_pair(label: str, fn, device_reps: int, paced_reps: int) -> tuple[float, float]:
    """Device and host-paced milliseconds of one wrapper call, kept under
    ``label`` and ``label + " paced"`` in ``KERNEL_TIMINGS``."""
    return (kernel_time_ms(label, device_time_ms, fn, device_reps),
            kernel_time_ms(label + " paced", cuda_time_ms, fn, paced_reps))


def scene_views(scene, X, S, K: int):
    """The scene in the sensor frames of ``K`` robot poses around ``X``
    (steps of 5 cm and 0.02 rad): a [K, N] batch of real clouds, the shape
    the loop detector and the relocalizer hand the projector."""
    from srrg2_laser_slam_2d_tpu_torch.utils import cloud as cloud_op
    from srrg2_laser_slam_2d_tpu_torch.utils import geometry

    step = torch.tensor([0.05, -0.03, 0.02], device=X.device)
    views = [cloud_op.transform(scene, geometry.inverse(geometry.compose(X + k * step, S)))
             for k in range(K)]
    return cloud_op.Cloud(*(torch.stack(f).contiguous() for f in zip(*views)))


PROJECTOR_BATCHES = (1, 4, 16)


def check_projector_kernel(proj, scene, X, S, meas) -> dict:
    """Kernel 8 against its plain version on the scene in the sensor frame:
    index and depth of every beam EQUAL (same operations in the same order,
    no sums); then a [16, N] batch of views against 16 plain calls. Times
    at N = 8,192 and at the route shapes: the clip (one row per beam) and
    the measurement (1,024 rows) of every ICP, and [K, 8,192] batches."""
    from srrg2_laser_slam_2d_tpu_torch.ops import clip as clip_op
    from srrg2_laser_slam_2d_tpu_torch.ops import projector_kernel as pk

    views = scene_views(scene, X, S, max(PROJECTOR_BATCHES))
    xy, valid = views.xy[0], views.valid[0]
    k = pk.project_local(proj, xy, valid)
    torch.cuda.synchronize()
    p = pk.project_local_plain(proj, xy, valid)
    hits = int(p.valid.sum())
    assert hits >= 300, hits
    assert torch.equal(k.idx, p.idx) and torch.equal(k.valid, p.valid), "winner indices differ"
    err = float((k.depth - p.depth).abs().max())
    assert err == 0.0, f"projector kernel depths differ by {err}"
    before = pk.launches
    kb = pk.project_local(proj, views.xy, views.valid)
    torch.cuda.synchronize()
    assert pk.launches == before + 1, "a batch of clouds must take one launch"
    for j in range(views.xy.shape[0]):
        pj = pk.project_local_plain(proj, views.xy[j], views.valid[j])
        assert torch.equal(kb.idx[j], pj.idx) and torch.equal(kb.depth[j], pj.depth), \
            f"batched projector kernel differs from the plain version on cloud {j}"
    n = xy.shape[0]
    B = pk.cols_padded(proj)
    ms, paced_ms = timed_pair("projector_kernel", lambda: pk.project_local(proj, xy, valid),
                              100, 200)
    plain_ms = cuda_time_ms(lambda: pk.project_local_plain(proj, xy, valid), 20)
    from srrg2_laser_slam_2d_tpu_torch.ops import projector as projector_op
    local = views.map(lambda x: x[0])
    scatter_ms = cuda_time_ms(lambda: projector_op.project_local_scatter(proj, local), 50)
    clip = clip_op.clip_projective(proj, scene, X, S).map(lambda x: x.contiguous())
    # label -> (points, valid, calls timed); a wrapper that launched once per
    # cloud could not keep the queue full over 100 calls of a batch
    shapes = {f"N={clip.capacity}": (clip.xy, clip.valid, 100),
              f"N={meas.capacity}": (meas.xy, meas.valid, 100)}
    shapes.update({f"[{K},{n}]": (views.xy[:K], views.valid[:K], max(6, 100 // K))
                   for K in PROJECTOR_BATCHES})
    route_shapes = {}
    for label, (sxy, sv, reps) in shapes.items():
        d, h = timed_pair(f"projector_kernel {label}",
                          lambda sxy=sxy, sv=sv: pk.project_local(proj, sxy, sv), reps, reps)
        route_shapes[label] = {"ms": d, "host_paced_ms": h}
        log(f"projector kernel {label}: {d:.5f} ms device, {h:.5f} ms at the host's pace")
    log(f"projector kernel: {hits} beams hit, indices and depths equal, single and "
        f"[{views.xy.shape[0]}, {n}] batched; the port's scatter-min project_local "
        f"(several PyTorch calls) takes {scatter_ms:.4f} ms")
    return entry("projector_kernel", "projector_kernel.cu", "pallas_projector.py:131", err, ms,
                 plain_ms, n * 9 + B * 8, n * pk.FLOPS_PER_POINT, f"N={n} B={B}",
                 host_paced_ms=paced_ms, scatter_project_local_ms=scatter_ms,
                 route_shapes=route_shapes)


def check_scene_kernel(proj, scene, X, S, meas) -> dict:
    """Kernel 7 against its plain version: winner rows EQUAL, depths equal,
    fields within 1e-6 (single winners are copied, tied ones averaged), on
    the scene seen from the robot (the clip's and the merge's scene canvas)
    and on the measurement from the identity (the merge's measurement
    canvas, 1,024 rows)."""
    from srrg2_laser_slam_2d_tpu_torch.ops import scene_kernel as sk
    from srrg2_laser_slam_2d_tpu_torch.utils import geometry

    cam = geometry.compose(X, S)
    zero = torch.zeros(3, device=cam.device)
    err = 0.0
    for cloud, pose in ((scene, cam), (meas, zero)):
        ko, kr = sk.canvas(proj, cloud, pose)
        torch.cuda.synchronize()
        po, p_rows = sk.canvas_plain(proj, cloud, pose)
        assert torch.equal(kr, p_rows), "winner rows differ"
        assert torch.equal(ko[0], po[0]) and torch.equal(ko[5], po[5]), "depths differ"
        err = max(err, float((ko - po).abs().max()))
        assert err <= 1e-6, f"scene kernel fields differ by {err}"
        log(f"scene kernel, {cloud.capacity} rows: {int((p_rows >= 0).sum())} beams hit, "
            f"rows and depths equal, fields within {err:.3g}")
    n, B = scene.capacity, ko.shape[1]
    ms, paced_ms = timed_pair("scene_kernel", lambda: sk.canvas(proj, scene, cam), 100, 200)
    plain_ms = cuda_time_ms(lambda: sk.canvas_plain(proj, scene, cam), 10)
    d, h = timed_pair(f"scene_kernel N={meas.capacity}", lambda: sk.canvas(proj, meas, zero),
                      100, 100)
    log(f"scene kernel N={meas.capacity}: {d:.5f} ms device, {h:.5f} ms at the host's pace")
    return entry("scene_kernel", "scene_kernel.cu", "pallas_scene.py:159", err, ms, plain_ms,
                 n * 17 + 12 + B * 28, n * sk.FLOPS_PER_POINT, f"N={n} B={B} chunk=1024",
                 host_paced_ms=paced_ms,
                 route_shapes={f"N={meas.capacity}": {"ms": d, "host_paced_ms": h}})


def compare_align(label: str, k, p) -> float:
    """Aligner kernel against its plain version: estimate within 1e-5, the
    counts of every pass equal or 1 apart (a beam at a gate, block sums in
    another order), chi within rtol 1e-3."""
    err = float((k.estimate - p.estimate).abs().max())
    ks = torch.cat([torch.stack([k.chi, k.num_corr, k.num_inliers, k.chi_inl_sum])[None],
                    k.iter_stats])
    ps = torch.cat([torch.stack([p.chi, p.num_corr, p.num_inliers, p.chi_inl_sum])[None],
                    p.iter_stats])
    count_diff = float((ks[:, 1:3] - ps[:, 1:3]).abs().max())
    chi_rel = float(((ks[:, [0, 3]] - ps[:, [0, 3]]).abs()
                     / ps[:, [0, 3]].abs().clamp(min=1e-3)).max())
    log(f"{label}: estimate {p.estimate.cpu().numpy().tolist()}, max abs err {err:.3g}; "
        f"correspondences {float(p.num_corr):.0f}, inliers {float(p.num_inliers):.0f}, "
        f"largest count difference over all passes {count_diff:.0f}, chi rel diff {chi_rel:.3g}")
    assert float(p.num_inliers) >= 100, "the check needs a real alignment"
    assert err <= 1e-5, f"{label}: estimates differ by {err}"
    assert count_diff <= 1 and chi_rel <= 1e-3, label
    return err


def compare_tied(proj, B, kernel, plain, meas, clip, beam_indexed, T0, kw, label) -> float:
    """``compare_align`` on the same call with forced two- and three-way
    bitwise depth ties (``bench.synthetic.with_tied_rows``) at the closest
    depth of their beams in the fixed canvas and, but for the banded
    kernel's beam-indexed clip, in the moving z-buffer at the initial
    estimate, where the tied rows' normals differ."""
    from srrg2_laser_slam_2d_tpu_torch.bench.synthetic import tie_counts, with_tied_rows

    views = {"fixed": (proj, torch.zeros(3, device=T0.device), B), "moving": (proj, T0, B)}
    tf = with_tied_rows(meas, 1, view=views["fixed"])
    tm = with_tied_rows(clip, 2, beam_indexed, view=None if beam_indexed else views["moving"])
    for name, cloud in (("fixed", tf), ("moving", tm))[: 1 + (not beam_indexed)]:
        ties = tie_counts(cloud, views[name])
        assert {2, 3} <= ties, f"{label}: the {name} cloud's ties {ties} lack 2 or 3"
    args = (tf.xy, tf.normal, tf.valid, tm.xy, tm.normal, tm.valid, T0)
    k = kernel(proj, *args, **kw)
    torch.cuda.synchronize()
    return compare_align(f"{label}, tied depths", k, plain(proj, *args, **kw))


def check_align_kernels(proj, acfg, scene, X, S, meas, T0) -> list[dict]:
    from srrg2_laser_slam_2d_tpu_torch.ops import banded_align_kernel as bak
    from srrg2_laser_slam_2d_tpu_torch.ops import clip as clip_op
    from srrg2_laser_slam_2d_tpu_torch.ops import projective_align_kernel as pak
    from srrg2_laser_slam_2d_tpu_torch.ops import scene_kernel as sk

    kw = dict(odom_prior=T0, iterations=acfg.max_iterations,
              point_distance=acfg.point_distance, normal_cos=acfg.normal_cos,
              chi_threshold=acfg.chi_threshold, min_inliers=acfg.min_num_inliers,
              odom_weight=acfg.odom_weight)
    passes = acfg.max_iterations + 1
    F = meas.capacity
    fixed = (meas.xy, meas.normal, meas.valid)
    out_bytes = 4 * (3 + 4 + 4 * acfg.max_iterations)
    out = []
    # kernel 5: the moving cloud is the plain projective clip (one row per beam)
    clip = clip_op.clip_projective(proj, scene, X, S).map(lambda x: x.contiguous())
    mov = (clip.xy, clip.normal, clip.valid)
    k = bak.fused_projective_align_banded(proj, *fixed, *mov, T0, **kw)
    torch.cuda.synchronize()
    p = bak.fused_projective_align_banded_plain(proj, *fixed, *mov, T0, **kw)
    err = compare_align(f"banded align kernel, {int(clip.valid.sum())} of {clip.capacity} lanes "
                        f"valid, {int(meas.valid.sum())} fixed rows", k, p)
    B = pak.align_spec(proj, 1, 0, 0, 0, 0, 0).cols_padded
    err = max(err, compare_tied(proj, B, bak.fused_projective_align_banded,
                                bak.fused_projective_align_banded_plain, meas, clip, True, T0,
                                kw, "banded align kernel"))
    ms = kernel_time_ms(
        "banded_align_kernel", device_time_ms,
        lambda mov=mov: bak.fused_projective_align_banded(proj, *fixed, *mov, T0, **kw), 100)
    paced_ms = kernel_time_ms(
        "banded_align_kernel paced", cuda_time_ms,
        lambda mov=mov: bak.fused_projective_align_banded(proj, *fixed, *mov, T0, **kw), 100)
    plain_ms = cuda_time_ms(
        lambda: bak.fused_projective_align_banded_plain(proj, *fixed, *mov, T0, **kw), 3)
    out.append(entry("banded_align_kernel", "banded_align_kernel.cu",
                     "pallas_banded_align.py:162", err, ms, plain_ms,
                     17 * (F + clip.capacity) + 24 + out_bytes,
                     F * pak.FLOPS_PER_CANVAS_POINT + passes * bak.flops_per_pass(B),
                     f"F={F} M={clip.capacity} B={B} iterations={acfg.max_iterations}",
                     host_paced_ms=paced_ms))
    # kernel 4: the moving cloud is the kernel clip (one row per padded beam)
    clip = sk.clip_projective(proj, scene, X, S).map(lambda x: x.contiguous())
    mov = (clip.xy, clip.normal, clip.valid)
    k = pak.fused_projective_align(proj, *fixed, *mov, T0, **kw)
    torch.cuda.synchronize()
    p = pak.fused_projective_align_plain(proj, *fixed, *mov, T0, **kw)
    err = compare_align(f"projective align kernel, {int(clip.valid.sum())} of {clip.capacity} "
                        "moving rows valid", k, p)
    B = sk.cols_padded(proj)
    err = max(err, compare_tied(proj, B, pak.fused_projective_align,
                                pak.fused_projective_align_plain, meas, clip, False, T0, kw,
                                "projective align kernel"))
    # the ball clipper hands the dense kernel the whole scene (8,192 rows),
    # here in a seeded random order: valid rows lie both among the 4,096 the
    # kernel packs in shared memory and past them, where it reads them from
    # global memory at each pass
    ball = clip_op.clip_ball(scene, X, S, 10.0)
    order = torch.randperm(ball.capacity, generator=torch.Generator().manual_seed(0))
    ball = ball.map(lambda x: x[order.to(x.device)].contiguous())
    bmov = (ball.xy, ball.normal, ball.valid)
    k = pak.fused_projective_align(proj, *fixed, *bmov, T0, **kw)
    torch.cuda.synchronize()
    err = max(err, compare_align(
        f"projective align kernel, ball clip, {int(ball.valid.sum())} of {ball.capacity} moving "
        f"rows valid, {int(ball.valid[4096:].sum())} of them past row 4,096", k,
        pak.fused_projective_align_plain(proj, *fixed, *bmov, T0, **kw)))
    ms = kernel_time_ms("projective_align_kernel", device_time_ms,
                        lambda: pak.fused_projective_align(proj, *fixed, *mov, T0, **kw), 100)
    paced_ms = kernel_time_ms(
        "projective_align_kernel paced", cuda_time_ms,
        lambda: pak.fused_projective_align(proj, *fixed, *mov, T0, **kw), 100)
    plain_ms = cuda_time_ms(
        lambda: pak.fused_projective_align_plain(proj, *fixed, *mov, T0, **kw), 3)
    out.append(entry("projective_align_kernel", "projective_align_kernel.cu",
                     "pallas_projective_align.py:303", err, ms, plain_ms,
                     17 * (F + clip.capacity) + 24 + out_bytes,
                     F * pak.FLOPS_PER_CANVAS_POINT
                     + passes * pak.flops_per_pass(clip.capacity, B),
                     f"F={F} M={clip.capacity} B={B} iterations={acfg.max_iterations}",
                     host_paced_ms=paced_ms))
    return out


def check_message_kernels(msgs, slam_cfg, pcfg, device) -> list[dict]:
    """Kernels 8, 7, 5 and 4 against their plain versions on the card."""
    proj = slam_cfg.tracker.projection
    scene, X, S, meas, T0 = tracked_scene(msgs, slam_cfg, pcfg, device)
    return [check_projector_kernel(proj, scene, X, S, meas),
            check_scene_kernel(proj, scene, X, S, meas),
            *check_align_kernels(proj, slam_cfg.tracker.aligner, scene, X, S, meas, T0)]


# ------------------------------------------------------ the per-message path

def _launch_modules():
    from srrg2_laser_slam_2d_tpu_torch.bench import exp_gather
    from srrg2_laser_slam_2d_tpu_torch.ops import (banded_align_kernel, beam_zbuffer_kernel,
                                                   frame_kernel, materialize_kernel,
                                                   multicue_align_kernel, nn_icp_kernel,
                                                   projective_align_kernel, projector_kernel,
                                                   scene_kernel, stream_kernel)
    return {"frame_kernel": frame_kernel, "nn_icp_kernel": nn_icp_kernel,
            "stream_kernel": stream_kernel, "projector_kernel": projector_kernel,
            "scene_kernel": scene_kernel, "banded_align_kernel": banded_align_kernel,
            "projective_align_kernel": projective_align_kernel,
            "multicue_align_kernel": multicue_align_kernel,
            "beam_zbuffer_kernel": beam_zbuffer_kernel, "gather_probe_kernel": exp_gather,
            "materialize_kernel": materialize_kernel}


def reset_launches() -> None:
    for mod in _launch_modules().values():
        mod.launches = 0
        if hasattr(mod, "calls"):
            mod.calls.clear()


def read_calls() -> dict:
    """Each kernel's calls since ``reset_launches`` by shape: {"N x batch":
    count} for the wrappers that keep a histogram (kernels 7 and 8)."""
    return {name: {f"{n}x{b}": c for (n, b), c in sorted(mod.calls.items())}
            for name, mod in _launch_modules().items() if getattr(mod, "calls", None)}


def read_launches() -> dict:
    return {name: mod.launches for name, mod in _launch_modules().items()}


def ate_of(trajectory) -> tuple[dict, bool]:
    """ATE of a (timestamp, pose, seconds) trajectory against the corridor's
    ground truth, and whether it breaks ``CORRIDOR_THRESHOLDS``."""
    from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e
    from srrg2_laser_slam_2d_tpu_torch.bench import suite as suite_mod
    from srrg2_laser_slam_2d_tpu_torch.io import tum

    bench = suite_mod.BenchmarkSuite()
    bench.set_ground_truth(*tum.read_tum(corridor_e2e.GROUND_TRUTH))
    for t, p, d in trajectory:
        bench.set_pose_estimate(p, t, d)
    stats = bench.compute()
    return stats, bench.is_regression(suite_mod.CORRIDOR_THRESHOLDS, stats)


def route_d_run(msgs) -> dict:
    """Route D, the default on a card: the WHOLE corridor through
    ``generic_bench_app`` under ``corridor.json`` (``use_fast_tracker``: one
    launch of the frame kernel per message)."""
    from srrg2_laser_slam_2d_tpu_torch.apps import generic_bench_app as app
    from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e

    os.makedirs(OUT_DIR, exist_ok=True)
    args = app.parser().parse_args([
        "-i", corridor_e2e.DATA, "--gt", corridor_e2e.GROUND_TRUTH,
        "-c", "configurations/corridor.json", "--gate", "corridor",
        "--json-out", os.path.join(OUT_DIR, "per_message.json"),
        "-o", os.path.join(OUT_DIR, "per_message.tum")])
    reset_launches()
    rc, art, runner = app.run(args, msgs)
    launches = read_launches()
    traj = np.stack([p for _, p, _ in runner.trajectory])
    n = art["frames"]
    out = {"route": "D", "frames": n, "wall_s": art["total_dataset_time_s"],
           "frames_per_s": n / art["total_dataset_time_s"],
           "mean_frame_hz": art["mean_frame_hz"],
           "ate_rmse_translation_m": art["ate"]["rmse_translation"],
           "graph_variables": art["graph_variables"], "graph_factors": art["graph_factors"],
           "closures": art["closures"], "relocalizations": art["relocalizations"],
           "gate_verdict": art["gate_verdict"], "exit_code": rc,
           "preprocess_s": art["preprocess_time_s"], "phases": art["phases"],
           "launches": {k: v for k, v in launches.items() if v}}
    log(f"per-message route D, whole corridor: {json.dumps(out)}")
    assert n == 2871 and traj.shape == (n, 3) and np.isfinite(traj).all()
    assert art["graph_variables"] >= 2, "no local-map split"
    assert art["closures"] >= 1, "no loop closure was accepted"
    # one launch per message after the first (a split reseeds without a launch)
    assert launches["frame_kernel"] == n - 1, launches
    return out


MESSAGE_ROUTES = (
    ("A", dict(use_fused_aligner=True, banded_aligner=True), None),
    ("A reuse_clip_canvas", dict(use_fused_aligner=True, banded_aligner=True,
                                 reuse_clip_canvas=True), None),
    ("A lean_scene_ops", dict(use_fused_aligner=True, banded_aligner=True,
                              reuse_clip_canvas=True, lean_scene_ops=True), None),
    ("B", dict(use_fused_aligner=True, use_fused_scene_ops=True), None),
    ("B reuse_clip_canvas", dict(use_fused_aligner=True, use_fused_scene_ops=True,
                                 reuse_clip_canvas=True), None),
    ("C kernel z-buffer", {}, "kernel"),
)


def message_route_run(name, flags, backend, slam_cfg, pcfg, msgs, device) -> tuple[dict, object]:
    """One tracker route over the first ``MESSAGE_FRAMES`` corridor frames
    through ``SlamRunner``; asserts the route's launch counts."""
    import dataclasses

    from srrg2_laser_slam_2d_tpu_torch.io.sources import ListSource
    from srrg2_laser_slam_2d_tpu_torch.models.runner import SlamRunner
    from srrg2_laser_slam_2d_tpu_torch.ops import projector as projector_op

    cfg = dataclasses.replace(slam_cfg, use_fast_tracker=False,
                              tracker=dataclasses.replace(slam_cfg.tracker, **flags))
    runner = SlamRunner(slam_config=cfg, preprocessor_config=pcfg, device=device)
    projector_op.ZBUFFER_BACKEND = backend
    try:
        reset_launches()
        t0 = time.perf_counter()
        n = runner.run(ListSource(msgs), MESSAGE_FRAMES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, calls = read_launches(), read_calls()
    finally:
        projector_op.ZBUFFER_BACKEND = None
    slam, tracker = runner.slam, runner.slam.tracker
    traj = np.stack([p for _, p, _ in runner.trajectory])
    stats, regression = ate_of(runner.trajectory)
    track_s = float(sum(d for _, _, d in runner.trajectory))
    out = {"route": name, "frames": n, "wall_s": wall, "frames_per_s": n / wall,
           "tracked_frames": tracker.steps, "cached_clips": tracker.cached_clips,
           "process_s": track_s, "preprocess_s": runner.preprocess_time,
           "phases": runner.timing_summary().get("phases", {}),
           "ate_rmse_translation_m": float(stats["rmse_translation"]),
           "graph_variables": slam.num_variables(), "graph_factors": slam.num_factors(),
           "closures": slam.num_closures, "relocalizations": slam.relocalizations,
           "launches": {k: v for k, v in launches.items() if v}, "calls": calls}
    log(f"per-message route {name}, {n} frames: {json.dumps(out)}")
    assert n == MESSAGE_FRAMES and traj.shape == (n, 3) and np.isfinite(traj).all()
    assert tracker.steps == n - 1
    assert not regression, f"route {name}: ATE outside CORRIDOR_THRESHOLDS: {stats}"
    steps = tracker.steps
    if name.startswith("A"):
        assert launches["banded_align_kernel"] == steps, launches
        assert launches["projective_align_kernel"] == launches["scene_kernel"] == 0
    elif name.startswith("B"):
        assert launches["projective_align_kernel"] == steps, launches
        # one canvas for the clip unless it came from the cache, two in the merge
        assert launches["scene_kernel"] == 3 * steps - tracker.cached_clips, launches
        assert tracker.cached_clips > 0 or not flags.get("reuse_clip_canvas")
        assert launches["banded_align_kernel"] == 0
    else:
        # per tracked frame: 1 clip, 1 + iterations in the aligner, 2 in the merge
        per_step = 4 + cfg.tracker.aligner.max_iterations
        assert launches["projector_kernel"] >= per_step * steps, launches
        assert launches["banded_align_kernel"] == launches["projective_align_kernel"] == 0
    return out, traj


def message_routes_run(slam_cfg, pcfg, msgs, device) -> list[dict]:
    outs, trajs = [], {}
    for name, flags, backend in MESSAGE_ROUTES:
        out, trajs[name] = message_route_run(name, flags, backend, slam_cfg, pcfg, msgs, device)
        outs.append(out)
    ref = trajs["C kernel z-buffer"]
    for name, traj in trajs.items():
        rms = float(np.sqrt(((traj[:, :2] - ref[:, :2]) ** 2).sum(1).mean()))
        log(f"route {name}: trajectory RMS to route C over {len(traj)} frames {rms:.4f} m "
            "(printed, not held: the loop is chaotic once maps split)")
        next(o for o in outs if o["route"] == name)["rms_to_route_c_m"] = rms
    return outs


def routes_in_one_map(slam_cfg, pcfg, msgs, device) -> dict:
    """The routes held to each other where that is fair: ``LaserTracker``
    over ``ONE_MAP_SCANS`` consecutive corridor scans inside one local map
    (no SLAM layer, so no split); routes A and B against route C's
    ``robot_in_local_map`` within 0.01 m and 0.01 rad at every frame."""
    import dataclasses

    from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e
    from srrg2_laser_slam_2d_tpu_torch.models.tracker import LaserTracker

    clouds, odoms = corridor_e2e.first_frames(msgs, ONE_MAP_SCANS, pcfg, device)
    poses = {}
    for name, flags in (("C", {}), ("A", MESSAGE_ROUTES[0][1]), ("B", MESSAGE_ROUTES[3][1])):
        tracker = LaserTracker(dataclasses.replace(slam_cfg.tracker, **flags), device=device)
        rows = []
        for k in range(ONE_MAP_SCANS):
            tracker.compute(clouds.map(lambda x: x[k]), odoms[k])
            rows.append(tracker.robot_in_local_map.cpu().numpy())
        poses[name] = np.stack(rows)
    out = {}
    for name in ("A", "B"):
        d = np.abs(poses[name] - poses["C"])
        out[name] = {"max_translation_diff_m": float(d[:, :2].max()),
                     "max_rotation_diff_rad": float(d[:, 2].max())}
        log(f"{ONE_MAP_SCANS} scans in one local map, route {name} against route C: "
            f"{json.dumps(out[name])}; end pose {poses[name][-1].round(4).tolist()}")
        assert d[:, :2].max() < 0.01 and d[:, 2].max() < 0.01, (name, d.max(axis=0))
    assert np.linalg.norm(poses["C"][-1, :2]) > 0.5, "the robot must have moved"
    return out


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


def corridor_run(cfg_path: str, msgs, device, capture=None) -> tuple[dict, object]:
    from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e
    from srrg2_laser_slam_2d_tpu_torch.ops import frame_kernel, materialize_kernel, nn_icp_kernel

    frame_kernel.launches = 0
    nn_icp_kernel.launches = 0
    materialize_kernel.launches = 0
    materialize_kernel.calls.clear()
    with capture or contextlib.nullcontext():
        summary, runner = corridor_e2e.run_pass(cfg_path, CHUNK, None, device, msgs)
    torch.cuda.synchronize()
    summary["launches"] = {"frame_kernel": frame_kernel.launches,
                           "nn_icp_kernel": nn_icp_kernel.launches,
                           "materialize_kernel": materialize_kernel.launches}
    summary["materialize_calls"] = {f"{s}x{t}": c for (s, t), c
                                    in sorted(materialize_kernel.calls.items())}
    traj = np.stack([p for _, p, _ in runner.trajectory])
    assert traj.shape == (summary["frames"], 3) and np.isfinite(traj).all()
    summary["rms_vs_tpu_run_m"] = trajectory_rms_vs(runner, "bench/results/corridor_r05.tum")
    log(f"corridor {cfg_path}: {json.dumps(summary)}")
    assert summary["frames"] == 2871
    assert summary["gate_verdict"] == "PASS", summary
    assert corridor_e2e.closures_accepted(summary), "no loop closure was accepted"
    assert summary["launches"]["frame_kernel"] > 0 and summary["launches"]["nn_icp_kernel"] > 0
    assert summary["launches"]["materialize_kernel"] > 0
    return summary, runner


def corridor_projective_run(msgs, device, fused: dict) -> dict:
    """The corridor under ``corridor.json`` with the loop detector on the
    default ``projective`` backend (closure pairs aligned by batched
    projective ICP in plain PyTorch, no kernel), printed beside the
    ``fused_nn`` run's gate, ATE and closures. Informational: the gate
    decides for ``corridor.json`` as it is."""
    from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e

    with open("configurations/corridor.json") as f:
        doc = json.load(f)
    for obj in doc["objects"]:
        if obj.get("#class") == "LoopDetectorConfig":
            obj["backend"] = "projective"
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "corridor_projective.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    summary, runner = corridor_e2e.run_pass(path, CHUNK, None, device, msgs)
    torch.cuda.synchronize()
    traj = np.stack([p for _, p, _ in runner.trajectory])
    assert summary["frames"] == 2871 and np.isfinite(traj).all()
    keys = ("gate_verdict", "ate_rmse_translation_m", "closures", "graph_variables", "wall_s")
    log("corridor, detector backend projective against fused_nn: "
        + json.dumps({"projective": {k: summary[k] for k in keys},
                      "fused_nn": {k: fused[k] for k in keys},
                      "projective_phases": summary["phases"]}))
    return summary


# ------------------------------------------------------------------ phase 6

def headline_run(device) -> dict:
    """The throughput path through its entry points. The stream kernel's
    count is read over the K sweep (one launch per chained call, warm-up
    run included) and again over the headline; the materialize kernel's
    likewise (one or two launches per materialization, by the number of
    scenes), with its calls by (scenes, frames)."""
    from srrg2_laser_slam_2d_tpu_torch._device import card_description
    from srrg2_laser_slam_2d_tpu_torch.bench import headline, stream_bench
    from srrg2_laser_slam_2d_tpu_torch.ops import frame_kernel, materialize_kernel, stream_kernel

    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def per_call(scenes: int, lanes: int) -> int:
        return 1 if materialize_kernel.blocks_per_scene(scenes, lanes, sms) == 1 else 2

    reps = 5
    calls = (reps + 1) * stream_bench.CHAIN
    frame_kernel.launches = 0
    stream_kernel.launches = 0
    materialize_kernel.launches = 0
    materialize_kernel.calls.clear()
    spec, state0, measC, odoms = stream_bench.build_inputs(STREAM_FRAMES, device=device)
    T, _, B = measC.shape
    result = {"card": card_description(device), "num_beams": int(spec.projection.cols),
              "gn_iterations": spec.iterations,
              "single_stream": stream_bench.measure_single(spec, state0, measC, odoms,
                                                           reps=reps),
              "streams": []}
    assert frame_kernel.launches == calls and stream_kernel.launches == 0
    assert materialize_kernel.launches == calls * per_call(1, T * B)
    for k in STREAM_KS:
        before = stream_kernel.launches, materialize_kernel.launches
        result["streams"].append(stream_bench.measure_streams(spec, state0, measC, odoms, k,
                                                              reps=reps, parts=True))
        # one launch per chained call, then the parts: one launch for their
        # inputs and the kernel alone, warm-up included; the scenes of every
        # chained call and of the materialization alone
        assert stream_kernel.launches - before[0] == calls + 1 + (reps + 1)
        assert (materialize_kernel.launches - before[1]
                == (calls + reps + 1) * per_call(k, T * B)), (k, materialize_kernel.launches)
    log(json.dumps(result))
    sweep_launches = stream_kernel.launches

    stream_kernel.launches = 0
    before = materialize_kernel.launches
    line = headline.headline(device, reps=reps)
    log(json.dumps(line))
    assert line["mode"] == "k_stream" and line["streams"] == STREAM_K
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert stream_kernel.launches == calls
    assert materialize_kernel.launches - before == calls * per_call(STREAM_K, T * B)
    shapes = {f"{s}x{t}": c for (s, t), c in sorted(materialize_kernel.calls.items())}
    log(f"materialize kernel on the throughput path: {materialize_kernel.launches} launches, "
        f"calls by scenes x frames {shapes}")
    return {"stream_bench": result, "headline": line,
            "launches": {"stream_kernel": stream_kernel.launches,
                         "stream_kernel_sweep": sweep_launches,
                         "frame_kernel_single_stream": frame_kernel.launches,
                         "materialize_kernel_throughput": materialize_kernel.launches},
            "materialize_calls": shapes}


# ------------------------------------------------------------ the MULTI path

MULTI_STEPS = 400
MULTI_BEAMS = 721
MULTI_OCCLUDED = (0, 100, 160)     # the front laser sees nothing over steps 100-159
MULTI_FOV = (-np.pi / 2, np.pi / 2)  # each laser's field of view: 180 degrees
# m, the dual run's ATE over the whole drive: on the CPU the JAX package's
# kernel route reads 0.1249 m on this drive, the front laser alone 1.53 m
# (tests/multi_loop_witness.py); a tracker that loses the heading reads ~1 m
MULTI_ATE_LIMIT = 0.2
MULTI_KERNEL_FRAMES = 10
MULTI_BENCH_FRAMES = 128
MULTI_EXTRINSICS = ((0.2, 0.0, 0.0), (-0.2, 0.0, float(np.pi)))
MULTI_FRAMES = ("laser_frame_0", "laser_frame_1")


def multi_preprocessor():
    from srrg2_laser_slam_2d_tpu_torch.models.preprocessor import PreprocessorConfig

    return PreprocessorConfig(voxelize_resolution=0.02, normal_window=8)


def dual_drive(device):
    """The MULTI loop's log: the circle drive of tests/test_torch_slam.py
    (0.15 m and 2 pi / 40 per step, seed 5), ten laps, a front and a rear
    laser of 721 beams over 180 degrees each, integrated odometry noise 0.02,
    the front laser blanked over ``MULTI_OCCLUDED``. Returns the messages
    and the ground truth."""
    from srrg2_laser_slam_2d_tpu_torch.apps.synthetic_scene_generator import (
        dual_dataset_to_messages)
    from srrg2_laser_slam_2d_tpu_torch.bench import synthetic

    common = dict(steps=MULTI_STEPS, num_beams=MULTI_BEAMS, max_variance=0.02,
                  drift=(0.15, 0.0, 2 * np.pi / 40), seed=5, angle_min=MULTI_FOV[0],
                  angle_max=MULTI_FOV[1])
    dss = [synthetic.simulate(synthetic.SyntheticConfig(sensor_in_robot=e, **common), device)
           for e in MULTI_EXTRINSICS]
    msgs = dual_dataset_to_messages(*dss, frames=MULTI_FRAMES, odom_noise=0.02,
                                    occlude=MULTI_OCCLUDED, seed=5)
    return msgs, dss[0].robot_poses


def dual_packs(msgs, n: int, device):
    """The first ``n`` dual-laser packs of the log as cue-stacked clouds on
    the card, with the odometry of each."""
    from srrg2_laser_slam_2d_tpu_torch.io.messages import LaserMessage, OdometryMessage
    from srrg2_laser_slam_2d_tpu_torch.models.preprocessor import LaserModel, ScanPreprocessor
    from srrg2_laser_slam_2d_tpu_torch.utils import cloud as cloud_op

    pre = ScanPreprocessor(multi_preprocessor(), device=device)
    ranges, odoms = {"/scan_0": [], "/scan_1": []}, []
    for m in msgs:
        if isinstance(m, LaserMessage):
            pre.set_model(LaserModel(len(m.ranges), m.angle_min, m.angle_max, m.range_min,
                                     m.range_max))
            ranges[m.topic].append(np.asarray(m.ranges, np.float32))
        elif isinstance(m, OdometryMessage):
            odoms.append(np.asarray(m.pose, np.float32))
            if len(odoms) == n:
                break
    clouds = [pre.compute(np.stack(ranges[t])) for t in ("/scan_0", "/scan_1")]
    packs = [cloud_op.stack([c.map(lambda x: x[k]) for c in clouds]) for k in range(n)]
    return packs, np.stack(odoms)


def check_multicue_kernel(msgs, device) -> dict:
    """Kernel 6 against its plain version on real full-width inputs: the
    scene of a ``MultiCueTracker`` (``multi_slam``'s tracker, kernel route)
    after ``MULTI_KERNEL_FRAMES`` packs of the drive, both cues' clips of it
    (2 x 721 rows) and the next pack's measurements (2 x 721 rows), the
    odometry step as initial guess and prior, 10 iterations. Estimate within
    1e-5, the counts of every pass equal or 2 apart (a beam at a gate), chi
    within rtol 1e-3."""
    from srrg2_laser_slam_2d_tpu_torch.models import tracker as tracker_mod
    from srrg2_laser_slam_2d_tpu_torch.ops import multicue_align_kernel as mak
    from srrg2_laser_slam_2d_tpu_torch.utils import presets

    cfg = presets.multi_slam(MULTI_BEAMS, 8192, device=device)
    tcfg, a = cfg.tracker, cfg.tracker.aligner
    packs, odoms = dual_packs(msgs, MULTI_KERNEL_FRAMES + 1, device)
    trk = tracker_mod.MultiCueTracker(tcfg, cfg.cue_extrinsics, device=device)
    for k in range(MULTI_KERNEL_FRAMES):
        trk.compute(packs[k], odoms[k])
    st, extr = trk.state, trk.extrinsics
    mov, T0 = tracker_mod.multi_step_inputs(tcfg, st, extr, torch.from_numpy(odoms[-1]).to(device),
                                            st.has_odom)
    m = packs[-1]
    args, kw = tracker_mod.fused_multi_arguments(tcfg, m, extr, mov, T0)
    k = mak.fused_projective_align_multi(*args, **kw)
    torch.cuda.synchronize()
    p = mak.fused_projective_align_multi_plain(*args, **kw)
    err = float((k.estimate - p.estimate).abs().max())
    ks = torch.cat([torch.stack([k.chi, k.num_corr, k.num_inliers, k.chi_inl_sum])[None],
                    k.iter_stats])
    ps = torch.cat([torch.stack([p.chi, p.num_corr, p.num_inliers, p.chi_inl_sum])[None],
                    p.iter_stats])
    count_diff = float((ks[:, 1:3] - ps[:, 1:3]).abs().max())
    chi_rel = float(((ks[:, [0, 3]] - ps[:, [0, 3]]).abs()
                     / ps[:, [0, 3]].abs().clamp(min=1e-3)).max())
    C, F, M = m.xy.shape[0], m.xy.shape[1], mov.capacity
    log(f"multi-cue align kernel C={C} F={F} M={M}: estimate {p.estimate.cpu().numpy().tolist()}, "
        f"max abs err {err:.3g}; correspondences {float(p.num_corr):.0f}, inliers "
        f"{float(p.num_inliers):.0f}, largest count difference over all passes "
        f"{count_diff:.0f}, chi rel diff {chi_rel:.3g}")
    assert float(p.num_inliers) >= 200, "the check needs a real alignment"
    assert err <= 1e-5, f"multi-cue aligner: estimates differ by {err}"
    assert count_diff <= 2 and chi_rel <= 1e-3
    ms = kernel_time_ms("multicue_align_kernel", device_time_ms,
                        lambda: mak.fused_projective_align_multi(*args, **kw), 100)
    paced_ms = cuda_time_ms(lambda: mak.fused_projective_align_multi(*args, **kw), 100)
    plain_ms = cuda_time_ms(lambda: mak.fused_projective_align_multi_plain(*args, **kw), 3)
    passes = a.max_iterations + 1
    # in: both clouds (17 bytes a row), t0, prior, extrinsics; out: estimate,
    # stats and the iteration records
    bytes_moved = 17 * (C * F + M) + 24 + 12 * C + 4 * (3 + 4 + 4 * a.max_iterations)
    flops = C * F * 46 + passes * mak.flops_per_pass(C, M)   # the kernel walks M rows
    return entry("multicue_align_kernel", "multicue_align_kernel.cu",
                 "pallas_multicue_align.py:224", err, ms, plain_ms, bytes_moved, flops,
                 f"C={C} F={F} M={M} B={mak.cols_padded(tcfg.projection)} "
                 f"iterations={a.max_iterations}", host_paced_ms=paced_ms,
                 count_diff=count_diff, chi_rel_diff=chi_rel)


def multicue_bench_run(device) -> dict:
    """The three rates of ``bench/multicue_bench`` at full width (2 x 721
    beams, 10 iterations), the depth cut to ``MULTI_BENCH_FRAMES`` frames,
    one pass after the warm-up (the plain rates run at some 15 scans/s; the
    module's own defaults take 256 frames, 10 chained passes, best of 3);
    the kernel's time alone and its share of a fused step."""
    from srrg2_laser_slam_2d_tpu_torch.bench import multicue_bench

    result = multicue_bench.run(frames=MULTI_BENCH_FRAMES, chain=1, reps=1, device=device)
    log(f"multicue_bench: {json.dumps(result)}")
    for key in ("dual_cue_fused_scans_per_sec", "dual_cue_plain_scans_per_sec",
                "single_cue_plain_scans_per_sec"):
        assert np.isfinite(result[key]) and result[key] > 0, key
    assert result["kernel_launches"] == 2 * (MULTI_BENCH_FRAMES - 1), result["kernel_launches"]
    return result


def ate_vs(runner, gt_t, gt_poses) -> float:
    from srrg2_laser_slam_2d_tpu_torch.bench import suite as suite_mod

    bench = suite_mod.BenchmarkSuite()
    bench.set_ground_truth(np.asarray(gt_t, np.float64), gt_poses)
    for t, p, d in runner.trajectory:
        bench.set_pose_estimate(p, t, d)
    return float(bench.compute()["rmse_translation"])


def multi_loop_run(msgs, gt_poses, device) -> dict:
    """The MULTI loop: the dual log through ``SlamRunner`` with
    ``scan_topics`` (extrinsics from the TF tree) under
    ``presets.multi_slam(721, 8192)``, then the same log through the front
    laser alone under ``presets.laser0_slam(721, 8192)`` (on a card: the
    frame kernel per message); frames/s, phases, graph counters and ATE of
    both. Kernel 6's launches are counted from 0 over the dual run and must
    equal its tracked frames. PASS: dual ATE <= single-cue ATE, dual ATE <=
    ``MULTI_ATE_LIMIT``, and the graph closes (more factors than a chain of
    its variables)."""
    from srrg2_laser_slam_2d_tpu_torch.io.sources import ListSource, SynchronizedSource
    from srrg2_laser_slam_2d_tpu_torch.models.runner import SlamRunner
    from srrg2_laser_slam_2d_tpu_torch.utils import presets

    gt_t = [m.timestamp for m in msgs if getattr(m, "topic", "") == "/scan_0"]
    out, runners = {}, {}
    for name, kw, slam_cfg in (
            ("dual", dict(scan_topics=["/scan_0", "/scan_1"], sensor_frames=list(MULTI_FRAMES)),
             presets.multi_slam(MULTI_BEAMS, 8192, device=device)),
            ("single", dict(scan_topic="/scan_0", sensor_frame=MULTI_FRAMES[0]),
             presets.laser0_slam(MULTI_BEAMS, 8192, device=device))):
        runner = SlamRunner(slam_config=slam_cfg, preprocessor_config=multi_preprocessor(),
                            base_frame="base_frame", device=device, **kw)
        topics = ["/tf", "/odom"] + kw.get("scan_topics", [kw.get("scan_topic")])
        reset_launches()
        t0 = time.perf_counter()
        n = runner.run(SynchronizedSource(ListSource(msgs), topics, time_interval=0.1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        slam = runner.slam
        traj = np.stack([p for _, p, _ in runner.trajectory])
        out[name] = {"frames": n, "wall_s": wall, "frames_per_s": n / wall,
                     "tracker": type(slam.tracker).__name__,
                     "tracked_frames": getattr(slam.tracker, "steps", None),
                     "preprocess_s": runner.preprocess_time,
                     "phases": runner.timing_summary().get("phases", {}),
                     "ate_rmse_translation_m": ate_vs(runner, gt_t, gt_poses),
                     "graph_variables": slam.num_variables(),
                     "graph_factors": slam.num_factors(), "closures": slam.num_closures,
                     "relocalizations": slam.relocalizations,
                     "launches": {k: v for k, v in launches.items() if v}}
        runners[name] = runner
        log(f"MULTI loop, {name}: {json.dumps(out[name])}")
        assert n == MULTI_STEPS + 1 and traj.shape == (n, 3) and np.isfinite(traj).all()
    dual, single = out["dual"], out["single"]
    np.testing.assert_allclose(np.asarray(runners["dual"].slam.cfg.cue_extrinsics),
                               np.asarray(MULTI_EXTRINSICS), atol=1e-6)
    assert dual["tracker"] == "MultiCueTracker"
    assert dual["launches"].get("multicue_align_kernel", 0) == dual["tracked_frames"] > 0, dual
    verdict = (dual["ate_rmse_translation_m"] <= single["ate_rmse_translation_m"]
               and dual["graph_factors"] > dual["graph_variables"] - 1
               and dual["ate_rmse_translation_m"] <= MULTI_ATE_LIMIT)
    out["verdict"] = "PASS" if verdict else "FAIL"
    log(f"MULTI loop verdict {out['verdict']}: dual ATE {dual['ate_rmse_translation_m']:.4f} m "
        f"(limit {MULTI_ATE_LIMIT} m), single-cue ATE {single['ate_rmse_translation_m']:.4f} m, "
        f"dual graph {dual['graph_variables']} variables / {dual['graph_factors']} factors")
    assert verdict, out
    return out


def sm_clock_mhz() -> dict:
    """The card's SM clock now and its maximum, MHz (``nvidia-smi``)."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    now, top = (float(v) for v in out.strip().splitlines()[0].split(","))
    return {"sm": now, "max_sm": top}


# the gather probe's cases held bit for bit to the plain version, both forms:
# (K, lanes, shift); the last two are the CPU tests' size
GATHER_CASES = ((1, 768, 64), (8, 768, 64), (32, 768, 64), (2, 256, 16), (8, 256, 16))


def check_probes(msgs, device) -> list[dict]:
    """The two probe kernels against their plain versions at full width.
    The shift z-buffer: the cells of each of the first 20 front scans
    (721-beam canvas, B = 768) moved by a small pose, winners and validity
    EQUAL, depths within 1e-6, and as the TPU test holds it, 99.5 % of the
    beams agree with the projector's z-buffer; then the first scan's cells
    with forced two- and three-way depth ties at beams' minima
    (``bench/synthetic.with_tied_rows``), whose tie counts are asserted,
    held to the plain version the same way. The gather: both forms at K =
    8 and 32 (``bench/exp_gather.run``, the launches counted) and over
    ``GATHER_CASES`` EQUAL to the plain version; its time at 10 passes and
    at 1 beside ``torch.gather``'s (the function at 1 pass). Both: the
    device time of an empty kernel at the probe's launch shape (the floor
    under a launch), and for the roll form the floor its shared-memory
    loads set."""
    from srrg2_laser_slam_2d_tpu_torch.bench import exp_gather
    from srrg2_laser_slam_2d_tpu_torch.bench.synthetic import with_tied_rows
    from srrg2_laser_slam_2d_tpu_torch.ops import beam_zbuffer_kernel as bzk
    from srrg2_laser_slam_2d_tpu_torch.ops import projector as projector_op
    from srrg2_laser_slam_2d_tpu_torch.utils import cloud as cloud_op
    from srrg2_laser_slam_2d_tpu_torch.utils import presets

    proj = presets.reference_projection(MULTI_BEAMS)
    B = bzk.cols_padded(proj)
    packs, _ = dual_packs(msgs, 20, device)
    pose = torch.tensor([0.03, -0.02, 0.05], device=device)
    geos, agree = [], []
    for pack in packs:
        front = pack.map(lambda x: x[0])
        canvas = projector_op.project_local(proj, front)
        idx = canvas.idx.clamp(min=0)
        moved = cloud_op.transform(
            cloud_op.Cloud(front.xy[idx], front.normal[idx], canvas.valid), pose)
        geos.append(bzk.pack_cells(moved, proj))
        ref = projector_op.project_local(proj, moved)
        agree.append((moved, ref))
    tied = bzk.pack_cells(with_tied_rows(agree[0][0], 0, True,
                                         view=(proj, torch.zeros(3, device=device), B)), proj)
    ties = bzk.tie_counts(proj, tied)
    assert {2, 3} <= ties, f"the tied cells' tie counts {ties} lack 2 or 3"
    bzk.launches = 0
    outs = [bzk.beam_zbuffer_probe(proj, g) for g in geos]
    torch.cuda.synchronize()
    z_launches = bzk.launches
    err, fraction = 0.0, 1.0
    for g, o, (moved, ref) in zip(geos, outs, agree):
        p = bzk.beam_zbuffer_probe_plain(proj, g)
        assert torch.equal(o[4], p[4]) and torch.equal(o[3], p[3]), "z-buffer winners differ"
        err = max(err, float((o[:3] - p[:3]).abs().max()))
        s_ok = o[4, :MULTI_BEAMS] > 0
        fraction = min(fraction, float((s_ok == ref.valid).float().mean()))
    o, p = bzk.beam_zbuffer_probe(proj, tied), bzk.beam_zbuffer_probe_plain(proj, tied)
    assert torch.equal(o[4], p[4]) and torch.equal(o[3], p[3]), "tied z-buffer winners differ"
    tied_err = float((o[:3] - p[:3]).abs().max())
    log(f"shift z-buffer probe: {len(geos)} scans, winners equal, fields within {err:.3g}, "
        f"agreement with the projector z-buffer >= {fraction:.4f}; tied cells (lanes tied at "
        f"a beam's minimum: {sorted(ties)}) winners equal, fields within {tied_err:.3g}")
    assert max(err, tied_err) <= 1e-6 and fraction >= 0.995
    g0 = geos[0]
    ms = kernel_time_ms("beam_zbuffer_kernel", device_time_ms,
                        lambda: bzk.beam_zbuffer_probe(proj, g0), 100)
    empty_ms = device_time_ms(lambda: bzk.empty_launch(proj, device), 100)
    paced_ms = cuda_time_ms(lambda: bzk.beam_zbuffer_probe(proj, g0), 100)
    plain_ms = cuda_time_ms(lambda: bzk.beam_zbuffer_probe_plain(proj, g0), 20)
    # bytes: the 6 rows of geoT the kernel reads (rows 6-7 are never read)
    # and the 8 rows it writes
    b_ms, b_by = bound((6 + 8) * B * 4, B * bzk.FLOPS_PER_LANE)
    entries = [{"name": "beam_zbuffer_kernel", "route": "cuda",
                "source": "srrg2_laser_slam_2d_tpu_torch/csrc/beam_zbuffer_kernel.cu",
                "replaces": "tests/test_fast_tracker.py:81", "launches": z_launches,
                "max_abs_err": max(err, tied_err), "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "host_paced_ms": paced_ms, "empty_kernel_ms": empty_ms,
                "tie_counts": sorted(ties),
                "shape": f"B={B} cols={MULTI_BEAMS} max_shift={bzk.MAX_SHIFT}"}]
    log(f"beam_zbuffer_kernel B={B}: {ms:.5f} ms ({paced_ms:.4f} at the host's pace), "
        f"empty kernel at its launch shape {empty_ms:.5f} ms, plain {plain_ms:.3f} ms, "
        f"bound {b_ms:.6f} ms ({b_by})")

    exp_gather.launches = 0
    runs = [exp_gather.run(form, k, 10, device) for k in (8, 32) for form in exp_gather.FORMS]
    g_launches = exp_gather.launches
    assert all(r["err"] <= 1e-5 for r in runs), runs
    for k, lanes, shift in GATHER_CASES:
        canvas, idx = exp_gather.make_inputs(k, device, lanes, shift)
        ref = exp_gather.gather_probe_plain(canvas, idx, 10)
        for form in exp_gather.FORMS:
            out = exp_gather.gather_probe(canvas, idx, 10, form, shift)
            assert torch.equal(out, ref), (k, lanes, shift, form)
    log(f"gather probe: both forms EQUAL to the plain version at (K, lanes, shift) "
        f"{GATHER_CASES}")
    times = {}
    for k in (8, 32):
        canvas, idx = exp_gather.make_inputs(k, device)
        for form in exp_gather.FORMS:
            times[(form, k)] = kernel_time_ms(
                f"gather_probe_kernel {form} K={k}", device_time_ms,
                lambda canvas=canvas, idx=idx, form=form: exp_gather.gather_probe(
                    canvas, idx, 10, form), 100)
            times[(f"empty {form}", k)] = device_time_ms(
                lambda k=k, form=form: exp_gather.empty_launch(k, form=form, device=device), 100)
        # the function at one pass is one library call: torch.gather, its
        # int64 index made beforehand (the yardstick; the probe never calls it)
        idx64 = idx.long()[None].expand(canvas.shape)
        assert torch.equal(exp_gather.gather_probe(canvas, idx, 1),
                           torch.gather(canvas, 2, idx64))
        times[("direct iters=1", k)] = kernel_time_ms(
            f"gather_probe_kernel direct K={k} iters=1", device_time_ms,
            lambda canvas=canvas, idx=idx: exp_gather.gather_probe(canvas, idx, 1), 100)
        times[("torch.gather", k)] = device_time_ms(
            lambda canvas=canvas, idx64=idx64: torch.gather(canvas, 2, idx64), 100)
        times[("plain", k)] = cuda_time_ms(
            lambda canvas=canvas, idx=idx: exp_gather.gather_probe_plain(canvas, idx, 10), 20)
    clock = sm_clock_mhz()
    # the roll form's shared-memory loads: every lane reads 2S + 1 lanes of
    # each of the 8 fields in each of 10 passes, 4 bytes each, at one
    # 128-byte wavefront a cycle on each of the card's SMs at its maximum clock
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    roll_bytes = 8 * 32 * exp_gather.B * (2 * exp_gather.S + 1) * 10 * 4
    roll_floor_ms = roll_bytes / (128 * sms) / (clock["max_sm"] * 1e3)
    b_ms, b_by = bound(exp_gather.bytes_moved(32), exp_gather.flops(32, 10))
    log("gather probe (device ms): " + ", ".join(f"{f} K={k} {t:.5f}"
                                                 for (f, k), t in times.items())
        + f"; roll form's shared-memory floor at K=32 {roll_floor_ms:.5f} ms "
        f"({sms} SMs at {clock['max_sm']:.0f} MHz; SM clock now {clock['sm']:.0f} MHz)")
    entries.append({"name": "gather_probe_kernel", "route": "cuda",
                    "source": "srrg2_laser_slam_2d_tpu_torch/csrc/gather_probe_kernel.cu",
                    "replaces": "bench/exp_gather.py:61", "launches": g_launches,
                    "max_abs_err": 0.0, "ms": times[("direct", 32)],
                    "plain_ms": times[("plain", 32)], "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": times[("torch.gather", 32)],
                    "library": "torch.gather, one pass (the function at iters=1)",
                    "iters1_ms": times[("direct iters=1", 32)],
                    "roll_ms": times[("roll", 32)],
                    "empty_kernel_ms": {f: times[(f"empty {f}", 32)] for f in exp_gather.FORMS},
                    "roll_shared_floor_ms": roll_floor_ms, "sm_clock_mhz": clock,
                    "k8_ms": {f: t for (f, k), t in times.items() if k == 8},
                    "shape": f"K=32 B={exp_gather.B} S={exp_gather.S} iters=10 (form direct)",
                    "err_vs_numpy": max(r["err"] for r in runs)})
    return entries


def multi_path(device) -> dict:
    """Every phase of the MULTI slice: kernel 6 and the probes against their
    plain versions, the dual-cue benchmark, the MULTI loop."""
    msgs, gt = dual_drive(device)
    kernel = check_multicue_kernel(msgs, device)
    probes = check_probes(msgs, device)
    bench = multicue_bench_run(device)
    loop = multi_loop_run(msgs, gt, device)
    kernel["launches"] = loop["dual"]["launches"]["multicue_align_kernel"]
    return {"kernels": [kernel, *probes], "multicue_bench": bench, "multi_loop": loop,
            "drive": (msgs, gt)}


# ------------------------------------------------- the slam_app slice (phase 10)

CARMEN_STEPS = 400
CARMEN_BEAMS = 721
CHECKPOINT_AT = 200
# the resumed run's end pose against the uninterrupted run's: the JAX
# package's own tolerance for a resumed run (tests/test_longrun.py), which
# drops the validator's pending closures as the port's checkpoint does
RESUME_TOL_M = 0.3
ITER_CHI_RTOL = 1e-3


def png_check(path: str) -> dict:
    """The PNG's structure: the signature, then IHDR (8-bit RGB), IDAT
    inflating to h * (1 + 3 w) bytes, IEND."""
    import struct
    import zlib

    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: no PNG signature"
    chunks, pos = {}, 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        chunks[data[pos + 4:pos + 8]] = data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    raw = zlib.decompress(chunks[b"IDAT"])
    assert (depth, color) == (8, 2) and len(raw) == h * (1 + 3 * w), (w, h, len(raw))
    assert b"IEND" in chunks
    return {"width": w, "height": h, "bytes": len(data)}


def slam_app_corridor_run(corridor: dict) -> dict:
    """(a) The whole corridor through ``slam_app`` (``run`` is ``main``'s
    body and also returns the runner) under ``corridor.json`` with
    ``--chunked 1024``, the trajectory and the map written; the launch
    counters set to 0 just before and read just after."""
    from srrg2_laser_slam_2d_tpu_torch.apps import slam_app
    from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e
    from srrg2_laser_slam_2d_tpu_torch.io import tum

    out_tum = os.path.join(OUT_DIR, "slam_app_corridor.tum")
    out_png = os.path.join(OUT_DIR, "slam_app_corridor.png")
    args = slam_app.parser().parse_args([
        "-c", "configurations/corridor.json", "-i", corridor_e2e.DATA, "--chunked", str(CHUNK),
        "-o", out_tum, "--draw", out_png])
    reset_launches()
    t0 = time.perf_counter()
    rc, runner = slam_app.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    t, poses = tum.read_tum(out_tum)
    stats, regression = ate_of([(ti, p, 0.0) for ti, p in zip(t, poses)])
    slam = runner.slam
    summary = {"graph_variables": slam.num_variables(), "graph_factors": slam.num_factors()}
    out = {"frames": len(t), "wall_s": wall, "frames_per_s": len(t) / wall,
           "mean_frame_hz": runner.timing_summary()["mean_frame_hz"],
           "ate_rmse_translation_m": float(stats["rmse_translation"]),
           "phase6_ate_rmse_translation_m": corridor["ate_rmse_translation_m"],
           "gate_verdict": "REGRESSION" if regression else "PASS",
           "closures": slam.num_closures, **summary, "png": png_check(out_png),
           "launches": {k: v for k, v in launches.items() if v}}
    log(f"slam_app corridor --chunked {CHUNK}: {json.dumps(out)}")
    assert rc == 0 and len(t) == 2871 and np.isfinite(poses).all()
    assert out["gate_verdict"] == "PASS", out
    assert corridor_e2e.closures_accepted(summary), "no loop closure was accepted"
    # one launch per chunk: 2,871 frames in three chunks of 1,024
    assert launches["frame_kernel"] == 3 and launches["nn_icp_kernel"] >= 1, launches
    return out


def carmen_log(device) -> str:
    """The CARMEN log of the port's synthetic drive (721 beams, 400 steps)."""
    from srrg2_laser_slam_2d_tpu_torch.bench import synthetic

    ds = synthetic.simulate(synthetic.SyntheticConfig(steps=CARMEN_STEPS,
                                                      num_beams=CARMEN_BEAMS), device)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "synthetic_carmen.clf")
    synthetic.to_carmen(ds, path)
    return path


def check_native_loader(path: str) -> tuple[dict, dict]:
    """(b) The native parser, built from ``native/dataloader.cpp`` into
    ``build/``, against the Python parser on the same log: equal arrays.
    Returns (the phase's numbers, the native arrays)."""
    from srrg2_laser_slam_2d_tpu_torch.io import native_loader as nl

    t0 = time.perf_counter()
    nat = nl.load_carmen_arrays(path)
    native_s = time.perf_counter() - t0
    saved, nl._LIB = nl._LIB, None
    try:
        t0 = time.perf_counter()
        py = nl.load_carmen_arrays(path)
        python_s = time.perf_counter() - t0
    finally:
        nl._LIB = saved
    assert nat["backend"] == "native" and py["backend"] == "python", (nat["backend"], py["backend"])
    for key in ("ranges", "laser_pose", "odom_pose", "timestamp", "meta"):
        assert np.array_equal(nat[key], py[key]), f"native loader: {key} differs"
    out = {"scans": int(nat["ranges"].shape[0]), "beams": int(nat["ranges"].shape[1]),
           "native_s": native_s, "python_s": python_s}
    log(f"native CARMEN loader: {json.dumps(out)}")
    assert out["scans"] == CARMEN_STEPS + 1 and out["beams"] == CARMEN_BEAMS
    return out, nat


def bench_app_carmen(path: str, extra: list[str]) -> tuple[dict, object, dict]:
    """``generic_bench_app --carmen`` per message on the card (route D: the
    LASER_0 preset's frame kernel, one launch per tracked frame), the
    counters set to 0 just before and read just after."""
    from srrg2_laser_slam_2d_tpu_torch.apps import generic_bench_app as app

    args = app.parser().parse_args(["--carmen", path, "--gate", "simul", *extra])
    reset_launches()
    rc, art, runner = app.run(args)
    launches = read_launches()
    assert rc in (0, -1), rc          # -1: the simul gate's verdict, printed, not asserted
    traj = np.stack([p for _, p, _ in runner.trajectory])
    assert np.isfinite(traj).all()
    return art, runner, launches


def carmen_message_run(path: str) -> tuple[dict, object]:
    """(b) The whole CARMEN log through ``generic_bench_app --carmen``."""
    art, runner, launches = bench_app_carmen(path, [])
    n = art["frames"]
    out = {"frames": n, "wall_s": art["total_dataset_time_s"],
           "frames_per_s": n / art["total_dataset_time_s"], "mean_frame_hz": art["mean_frame_hz"],
           "ate_rmse_translation_m": art["ate"]["rmse_translation"],
           "gate_verdict": art["gate_verdict"], "graph_variables": art["graph_variables"],
           "closures": art["closures"], "relocalizations": art["relocalizations"],
           "launches": {k: v for k, v in launches.items() if v}}
    log(f"generic_bench_app --carmen, per message: {json.dumps(out)}")
    assert n == CARMEN_STEPS + 1 and len(runner.trajectory) == n
    assert type(runner.slam.tracker).__name__ == "FastTracker"
    # the first frame seeds the tracker, every later one is one launch
    assert launches["frame_kernel"] == n - 1, launches
    return out, runner


def checkpoint_run(path: str, whole) -> dict:
    """(c) The same log saved every 100 frames and stopped at frame 200,
    then the same command resumed from the checkpoint; the resumed run's
    end pose against the uninterrupted run's. Also one save and one load
    of the checkpoint timed alone."""
    from srrg2_laser_slam_2d_tpu_torch.models.slam import GraphSLAM2D
    from srrg2_laser_slam_2d_tpu_torch.utils import checkpoint as ckpt

    ck = os.path.join(OUT_DIR, "carmen_checkpoint.npz")
    for stale in (ck, ck[:-4] + ".meta.json"):
        if os.path.exists(stale):
            os.unlink(stale)
    flags = ["--checkpoint", ck, "--checkpoint-every", "100"]
    art1, first, _ = bench_app_carmen(path, flags + ["--max-frames", str(CHECKPOINT_AT)])
    assert art1["frames"] == CHECKPOINT_AT and len(ckpt.trajectory_from(ck)) == CHECKPOINT_AT
    timed = os.path.join(OUT_DIR, "carmen_checkpoint_timed.npz")
    t0 = time.perf_counter()
    ckpt.save(timed, first.slam, first.trajectory)
    save_s = time.perf_counter() - t0
    fresh = GraphSLAM2D(first.slam.cfg, sensor_in_robot=np.zeros(3, np.float32),
                        device=first.device)
    t0 = time.perf_counter()
    ckpt.load(timed, fresh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    assert fresh.n_maps == first.slam.n_maps
    assert np.abs(fresh.robot_in_world() - first.slam.robot_in_world()).max() <= 1e-6
    art2, resumed, launches = bench_app_carmen(path, flags)
    n = art2["frames"]
    end_d = float(np.linalg.norm(resumed.trajectory[-1][1][:2] - whole.trajectory[-1][1][:2]))
    out = {"first_frames": art1["frames"], "resumed_frames": n,
           "trajectory_rows": len(resumed.trajectory), "end_pose_apart_m": end_d,
           "save_s": save_s, "load_s": load_s, "checkpoint_bytes": os.path.getsize(timed),
           "graph_variables": resumed.slam.num_variables(),
           "resumed_ate_rmse_translation_m": art2["ate"]["rmse_translation"],
           "launches": {k: v for k, v in launches.items() if v}}
    log(f"checkpoint and resume: {json.dumps(out)}")
    assert n == CARMEN_STEPS + 1 - CHECKPOINT_AT and len(resumed.trajectory) == CARMEN_STEPS + 1
    assert launches["frame_kernel"] == n, launches     # one launch per frame after the resume
    assert end_d <= RESUME_TOL_M, out
    return out


def check_iteration_stats(log_arrays: dict, device) -> dict:
    """(d) Kernel 1's payload row 7 (per-iteration chi and inliers) against
    its plain version: one route-D frame of the CARMEN log (scans and
    odometry as the native loader read them, zero extrinsic as the app
    tracks them), the kernel through ``FastTracker.compute`` and the plain
    version from the state the tracker had just before."""
    from srrg2_laser_slam_2d_tpu_torch.models import fast_tracker as ft
    from srrg2_laser_slam_2d_tpu_torch.models.preprocessor import LaserModel, ScanPreprocessor
    from srrg2_laser_slam_2d_tpu_torch.models.slam import frame_spec
    from srrg2_laser_slam_2d_tpu_torch.ops import frame_kernel as fk
    from srrg2_laser_slam_2d_tpu_torch.utils import presets

    n_beams, angle_min, fov, range_max = (float(v) for v in log_arrays["meta"][0])
    ranges, odoms = log_arrays["ranges"], log_arrays["odom_pose"]
    pre = ScanPreprocessor(presets.laser0_preprocessor(), device=device)
    pre.set_model(LaserModel(int(n_beams), angle_min, angle_min + fov, 0.0,
                             min(range_max, 80.0)))
    spec = frame_spec(presets.laser0_slam(device=device))
    tracker = ft.FastTracker(spec, device=device)
    frame = 10
    for k in range(frame):
        tracker.compute(pre.compute(ranges[k]), odoms[k])
    before = tracker.state
    cloud = pre.compute(ranges[frame])
    tracker.compute(cloud, odoms[frame])
    kernel = tracker.iteration_stats().cpu().numpy()
    meas = ft.pack_measurement_canvas(spec, cloud, odoms[frame], True)
    _, _, pay = fk.track_frames_grid_plain(spec, before.cacheT, before.pose, meas[None])
    plain = ft.iteration_stats(spec, pay[0]).cpu().numpy()
    chi_rel = float((np.abs(kernel[:, 0] - plain[:, 0])
                     / np.maximum(np.abs(plain[:, 0]), 1e-12)).max())
    out = {"frame": frame, "iterations": int(spec.iterations), "chi_max_rel_err": chi_rel,
           "inliers_equal": bool(np.array_equal(kernel[:, 1], plain[:, 1])),
           "inliers": plain[:, 1].astype(int).tolist()}
    log(f"frame kernel row 7 (iteration_stats) against its plain version: {json.dumps(out)}")
    assert kernel.shape == (spec.iterations, 2) and (plain[:, 1] > 0).all()
    assert chi_rel <= ITER_CHI_RTOL and out["inliers_equal"], out
    return out


def generated_config_check(device) -> dict:
    """(e) ``slam_app -j`` writes the default assembly; it reads back equal."""
    from srrg2_laser_slam_2d_tpu_torch.apps import slam_app
    from srrg2_laser_slam_2d_tpu_torch.utils import config as config_mod
    from srrg2_laser_slam_2d_tpu_torch.utils import presets

    path = os.path.join(OUT_DIR, "slam_app_default.json")
    assert slam_app.main(["-j", "-c", path]) == 0
    back = config_mod.ConfigManager.read(path)
    want = presets.default_config_manager(device=device)
    names = sorted(want._names)
    assert sorted(back._names) == names
    for name in names:
        assert back.get_by_name(name) == want.get_by_name(name), name
    assert back.get_by_name("slam").use_fast_tracker
    out = {"names": names, "bytes": os.path.getsize(path)}
    log(f"slam_app -j read back equal: {json.dumps(out)}")
    return out


def slam_app_slice(corridor: dict, device) -> dict:
    """Every part of phase 10."""
    os.makedirs(OUT_DIR, exist_ok=True)
    app_run = slam_app_corridor_run(corridor)
    path = carmen_log(device)
    native, arrays = check_native_loader(path)
    message, whole = carmen_message_run(path)
    resume = checkpoint_run(path, whole)
    iters = check_iteration_stats(arrays, device)
    config = generated_config_check(device)
    return {"slam_app_corridor": app_run, "native_loader": native, "carmen_per_message": message,
            "checkpoint": resume, "iteration_stats": iters, "generated_config": config,
            "carmen_log": path}


# ------------------------- large pose graphs, finders, idle shares (phase 11)

CITY_SIDES = (256, 512, 1024)
CITY_GN, CITY_CG = 4, 100          # the TPU run pgo_1m_r05's budget
SCHUR_CHAINS = ((65536, 512), (262144, 1024))
SCHUR_GN = 3                       # bench/schur_scale_bench.py's iterations
SCHUR_REFUSED_PARTS = 650          # >= 512 and not a multiple of 256
SCHUR_REPEATS = 4
LM_CIRCLE = dict(n=20, noise=0.15, seed=3)    # tests/test_pgo.py::test_lm_never_increases_chi
LM_ITERATIONS = 30
FINDER_TOL = 1e-4
ROUTE_D_TRACE_FRAMES = 300
MULTI_TRACE_STEPS = 100
TRACE_DIR = "build/traces"         # full traces (too large for chiprun_out/)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device):
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" \
        else None


def city_scale_runs(device) -> list[dict]:
    """(a) The city-scale lattice through ``pgo_bench.run`` at each of
    ``CITY_SIDES`` (above 100k nodes: sorted segment sums and chunked
    linearization), 4 GN x 100 CG iterations: chi before, after and per GN
    iteration, seconds per GN iteration, peak device memory."""
    import dataclasses

    from srrg2_laser_slam_2d_tpu_torch.bench import pgo_bench

    out = []
    for side in CITY_SIDES:
        r = pgo_bench.run(side, gn_iterations=CITY_GN, cg_iterations=CITY_CG, reps=1,
                          device=device)
        row = dataclasses.asdict(r)
        log(f"city-scale lattice, side {side}: {json.dumps(row)}")
        assert r.finite, f"side {side}: poses not finite"
        assert np.isfinite(r.chi1) and r.chi1 < r.chi0, row
        out.append(row)
    # the largest side once more with index_add_ scatters and unchunked
    # linearization (``large=False``), beside the sorted sums above
    r = pgo_bench.run(CITY_SIDES[-1], gn_iterations=CITY_GN, cg_iterations=CITY_CG, reps=1,
                      large=False, device=device)
    row = {"large": False, **dataclasses.asdict(r)}
    log(f"city-scale lattice, side {CITY_SIDES[-1]}, index_add_ scatters: {json.dumps(row)}")
    assert r.finite and r.chi1 < r.chi0, row
    out.append(row)
    return out


def schur_outcome(chis: list, graph, solved) -> str:
    """How a Schur run on a chain ended: its chi sequence (initial, after
    each iteration) must keep the divergence guard's bound, every step's
    chi within 1e3 x the one before + 1e3 (the reference's contract on
    graphs whose float32 elimination fails); "stalled" where the guard
    kept every pose, else "reduced" or "grew"."""
    assert np.isfinite(chis).all(), chis
    assert all(b <= 1e3 * a + 1e3 for a, b in zip(chis, chis[1:])), chis
    if torch.equal(solved.poses, graph.poses):
        return "stalled"
    return "reduced" if chis[-1] < chis[0] else "grew"


def schur_chain_runs(device) -> list[dict]:
    """(b) Schur on the multi-session chains: ``SCHUR_CHAINS`` (nodes,
    partitions), the second past the dense separator solve's 8,192 rows;
    ``SCHUR_GN`` GN iterations; finite poses and the guard's bound on chi
    (``schur_outcome``); the last chain solved ``SCHUR_REPEATS`` more times
    (its outcome varies between runs: the float32 elimination of chain
    interiors fails, and the order of the atomic sums decides whether the
    guard admits the step); then ``SCHUR_REFUSED_PARTS`` partitions must be
    refused (the chunked elimination's P % 256 rule)."""
    from srrg2_laser_slam_2d_tpu_torch.bench import pgo_bench
    from srrg2_laser_slam_2d_tpu_torch.solver import pgo, schur

    out = []
    for n, parts in SCHUR_CHAINS:
        g = pgo_bench.make_chain_graph(n, device=device)
        sync(device)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        part = schur.partition_graph(g, parts)
        t1 = time.perf_counter()
        stats: list[dict] = []
        solved, chi, it = schur.optimize_schur(pgo.PGOConfig(max_iterations=SCHUR_GN), g, part,
                                               stats=stats)
        sync(device)
        t2 = time.perf_counter()
        chi0, chi1 = pgo_bench.edge_chi(g), pgo_bench.edge_chi(solved)
        d_s = 3 * part.separator_cap
        row = {"nodes": n, "edges": int(g.edge_valid.sum()), "partitions": parts,
               "interior_cap": part.interior_cap, "local_separator_cap": part.sep_local_cap,
               "separator_rows": d_s,
               "separator_solve": "dense" if d_s <= schur.DENSE_SEPARATOR_ROWS else "pcg",
               "partition_s": t1 - t0, "chi0": chi0, "chi1": chi1,
               "chi_per_iteration": [s["chi"] for s in stats], "iterations": it,
               "seconds_per_iteration": (t2 - t1) / max(it, 1),
               "peak_device_bytes": peak_bytes(device)}
        assert bool(torch.isfinite(solved.poses).all()), row
        row["outcome"] = schur_outcome([s["chi"] for s in stats] + [chi1], g, solved)
        log(f"Schur chain: {json.dumps(row)}")
        out.append(row)
    repeats = []
    for _ in range(SCHUR_REPEATS):
        stats = []
        solved, _, _ = schur.optimize_schur(pgo.PGOConfig(max_iterations=SCHUR_GN), g, part,
                                            stats=stats)
        assert bool(torch.isfinite(solved.poses).all())
        chi1 = pgo_bench.edge_chi(solved)
        repeats.append({"chi1": chi1,
                        "outcome": schur_outcome([s["chi"] for s in stats] + [chi1], g,
                                                 solved)})
    out[-1]["repeats"] = repeats
    log(f"Schur chain {SCHUR_CHAINS[-1]}, {SCHUR_REPEATS} more solves: {json.dumps(repeats)}")
    g = pgo_bench.make_chain_graph(SCHUR_CHAINS[0][0], device=device)
    try:
        schur.optimize_schur(pgo.PGOConfig(max_iterations=1), g,
                             schur.partition_graph(g, SCHUR_REFUSED_PARTS))
    except ValueError as e:
        log(f"Schur, {SCHUR_REFUSED_PARTS} partitions refused: {e}")
    else:
        raise AssertionError(f"{SCHUR_REFUSED_PARTS} partitions were not refused")
    return out


def circle_graph(n: int, noise: float, seed: int, device):
    """tests/test_pgo.py's circle graph (noisy odometry around a circle of n
    steps, an exact closure from the last pose to the first) from the same
    seed, through the port's geometry."""
    from srrg2_laser_slam_2d_tpu_torch.solver import pgo
    from srrg2_laser_slam_2d_tpu_torch.utils import geometry

    rng = np.random.default_rng(seed)
    step = torch.tensor([2 * np.pi * 5.0 / n, 0.0, 2 * np.pi / n])
    gt = [torch.zeros(3)]
    for _ in range(n - 1):
        gt.append(geometry.compose(gt[-1], step))
    est, meas = [gt[0]], []
    for k in range(1, n):
        z = geometry.relative(gt[k - 1], gt[k]).numpy() \
            + rng.normal(scale=noise, size=3).astype(np.float32)
        meas.append(z)
        est.append(geometry.compose(est[-1], torch.from_numpy(z)))
    meas.append(geometry.relative(gt[n - 1], gt[0]).numpy())
    poses = np.zeros((32, 3), np.float32)
    poses[:n] = torch.stack(est).numpy()
    ei, ej = np.zeros(64, np.int64), np.zeros(64, np.int64)
    ei[:n], ej[:n] = list(range(n - 1)) + [n - 1], list(range(1, n)) + [0]
    em = np.zeros((64, 3), np.float32)
    em[:n] = np.stack(meas)
    return pgo.graph_from_numpy(poses, np.arange(32) < n, np.arange(32) == 0, ei, ej, em,
                                np.ones((64, 3), np.float32), np.arange(64) < n, device=device)


def lm_run(device) -> dict:
    """(c) Levenberg-Marquardt on the seeded circle: the chi it returns
    after 1, 2, ... ``LM_ITERATIONS`` iterations never rises above the one
    before (nor the first above the initial chi), and the card's solution
    lies within 1e-3 of the port's on the CPU."""
    from srrg2_laser_slam_2d_tpu_torch.solver import pgo

    g = circle_graph(device=device, **LM_CIRCLE)
    chis = [float(pgo.graph_chi(g))]
    for k in range(1, LM_ITERATIONS + 1):
        _, chi, it = pgo.optimize(pgo.PGOConfig(max_iterations=k, algorithm="lm"), g)
        chis.append(float(chi))
        if it < k:
            break
    cfg = pgo.PGOConfig(max_iterations=LM_ITERATIONS, algorithm="lm")
    card, chi, it = pgo.optimize(cfg, g)
    cpu, cpu_chi, cpu_it = pgo.optimize(cfg, pgo.PoseGraph(*(x.cpu() for x in g)))
    diff = float((card.poses.cpu() - cpu.poses).abs().max())
    out = {"chi_per_iteration": chis, "iterations": it, "cpu_iterations": cpu_it,
           "chi": float(chi), "cpu_chi": float(cpu_chi), "max_pose_diff_vs_cpu": diff}
    log(f"LM on the circle graph: {json.dumps(out)}")
    assert all(b <= a * (1 + 1e-6) + 1e-9 for a, b in zip(chis, chis[1:])), chis
    assert np.isfinite(chis).all() and diff < 1e-3, out
    return out


def corridor_solver_runs(msgs, slam_cfg, pcfg, device, dense: dict) -> dict:
    """(d) The corridor through ``ChunkedSlamRunner`` under
    ``corridor.json`` with ``global_solver_kind`` "cg", then "schur" (in
    memory; the file stays as it is): the frame kernel launched 3 times and
    the NN-ICP kernel at least once from counters set to 0 before each run,
    at least one call reaching the solver, a finite trajectory; the gate,
    ATE and closures printed beside the dense run's (not asserted: no
    package has run the corridor on these solvers before)."""
    import dataclasses

    from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e
    from srrg2_laser_slam_2d_tpu_torch.ops import frame_kernel, nn_icp_kernel
    from srrg2_laser_slam_2d_tpu_torch.solver import cg, schur

    keys = ("gate_verdict", "ate_rmse_translation_m", "closures", "graph_variables",
            "graph_factors", "wall_s")
    out = {}
    for kind, mod, name in (("cg", cg, "optimize_cg"), ("schur", schur, "optimize_schur")):
        solve, calls = getattr(mod, name), []

        def counted(*a, solve=solve, calls=calls, **kw):
            calls.append(1)
            return solve(*a, **kw)

        setattr(mod, name, counted)
        try:
            frame_kernel.launches = 0
            nn_icp_kernel.launches = 0
            summary, runner = corridor_e2e.run_configs(
                dataclasses.replace(slam_cfg, global_solver_kind=kind), pcfg, CHUNK, None,
                device, msgs)
            sync(device)
            summary["launches"] = {"frame_kernel": frame_kernel.launches,
                                   "nn_icp_kernel": nn_icp_kernel.launches}
        finally:
            setattr(mod, name, solve)
        summary["solver_calls"] = len(calls)
        traj = np.stack([p for _, p, _ in runner.trajectory])
        log(f"corridor, global solver {kind}: {json.dumps(summary)}")
        log(f"corridor, {kind} against dense: " + json.dumps(
            {kind: {k: summary[k] for k in keys},
             "dense": {k: dense.get(k) for k in keys}}))
        assert summary["frames"] == 2871 and traj.shape == (2871, 3) and np.isfinite(traj).all()
        assert summary["launches"]["frame_kernel"] == 3, summary["launches"]
        assert summary["launches"]["nn_icp_kernel"] >= 1, summary["launches"]
        assert summary["solver_calls"] >= 1, f"no solve reached {name}"
        out[kind] = summary
    return out


def finder_runs(msgs, slam_cfg, pcfg, device) -> dict:
    """(e) ``icp.align`` with the ``nn_grid`` and ``bruteforce`` finders on
    the corridor's first two scans (tests/test_finder_plugins.py's settings:
    512 x 512 grid at 0.05 m, 0.5 m match distance, 10 iterations) on the
    card against the port on the CPU from the same clouds: estimates within
    ``FINDER_TOL``, the nearest field's indices EQUAL."""
    from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e
    from srrg2_laser_slam_2d_tpu_torch.ops import distance_map, icp

    clouds, _ = corridor_e2e.first_frames(msgs, 2, pcfg, device)
    fixed, moving = clouds.map(lambda x: x[0]), clouds.map(lambda x: x[1])
    proj = slam_cfg.tracker.projection
    out = {}
    for finder in ("nn_grid", "bruteforce"):
        cfg = icp.AlignerConfig(max_iterations=10, finder=finder, finder_max_distance=0.5,
                                finder_resolution=0.05, finder_grid_size=512)
        icp.align(cfg, proj, fixed, moving, torch.zeros(3, device=device))
        sync(device)
        t0 = time.perf_counter()
        card = icp.align(cfg, proj, fixed, moving, torch.zeros(3, device=device))
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        cpu = icp.align(cfg, proj, fixed.to("cpu"), moving.to("cpu"), torch.zeros(3))
        cpu_ms = (time.perf_counter() - t0) * 1e3
        err = float((card.estimate.cpu() - cpu.estimate).abs().max())
        out[finder] = {"estimate": card.estimate.cpu().tolist(),
                       "cpu_estimate": cpu.estimate.tolist(), "max_abs_err": err,
                       "correspondences": int(card.num_correspondences),
                       "cpu_correspondences": int(cpu.num_correspondences),
                       "iterations": int(card.iterations), "align_ms": ms,
                       "cpu_align_ms": cpu_ms}
        log(f"finder {finder}, card against CPU: {json.dumps(out[finder])}")
        assert err <= FINDER_TOL, out[finder]
    f_card = distance_map.build(fixed, 512, 512, 0.05)
    f_cpu = distance_map.build(fixed.to("cpu"), 512, 512, 0.05)
    out["nn_grid"]["field_idx_equal"] = bool(torch.equal(f_card.idx.cpu(), f_cpu.idx))
    out["nn_grid"]["field_dist2_max_diff"] = float((f_card.dist2.cpu() - f_cpu.dist2).abs().max())
    assert out["nn_grid"]["field_idx_equal"], "nearest field indices differ"
    return out


def busiest_kernels(events: list, n: int = 5) -> list:
    """The ``n`` kernels with the most device time in a Chrome trace's
    events: [name, launches, total us]."""
    by_name: dict[str, list] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            row = by_name.setdefault(e["name"][:100], [0, 0.0])
            row[0] += 1
            row[1] += float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n]
    return [[name, c, round(us, 1)] for name, (c, us) in top]


def traced(name: str, run) -> dict:
    """``run()`` once untimed-by-the-profiler (its wall clock), then under
    ``profiling.device_trace``: the card's idle share over the traced
    window, the window, its busy time, and the busiest kernels. The
    tracer's own host work stretches the window, so the untraced wall is
    printed beside it."""
    from srrg2_laser_slam_2d_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    with profiling.device_trace(os.path.join(TRACE_DIR, name)) as path:
        run()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    busy_ms = sum(b - a for a, b in profiling.busy_intervals(events)) / 1e3
    idle = profiling.idle_share(events)
    out = {"idle_share": idle, "device_busy_ms": busy_ms,
           "traced_window_s": busy_ms / 1e3 / (1.0 - idle), "untraced_wall_s": untraced,
           "trace_bytes": os.path.getsize(path), "events": len(events),
           "busiest_kernels": busiest_kernels(events)}
    log(f"idle share, {name}: {json.dumps(out)}")
    assert 0.0 <= out["idle_share"] < 1.0
    return out


def idle_share_runs(msgs, device) -> dict:
    """(f) The card's idle share, each in its own traced run: the corridor
    chunked loop under ``corridor.json`` (dense solver), route D over the
    first ``ROUTE_D_TRACE_FRAMES`` corridor frames, the MULTI loop over its
    first ``MULTI_TRACE_STEPS`` steps; and the two large solves, one GN
    iteration each: CG on the largest lattice (100 CG iterations, one host
    synchronisation each), Schur on the largest chain. Written to
    ``chiprun_out/idle_shares.json``; the traces stay under ``TRACE_DIR``."""
    from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e, pgo_bench
    from srrg2_laser_slam_2d_tpu_torch.io.sources import ListSource, SynchronizedSource
    from srrg2_laser_slam_2d_tpu_torch.models.runner import SlamRunner
    from srrg2_laser_slam_2d_tpu_torch.solver import cg, pgo, schur
    from srrg2_laser_slam_2d_tpu_torch.utils import config as config_mod
    from srrg2_laser_slam_2d_tpu_torch.utils import presets

    mgr = config_mod.ConfigManager.read("configurations/corridor.json")
    dual, _ = dual_drive(device)
    side = CITY_SIDES[-1]
    lattice = pgo_bench.make_grid_graph(side, edge_align=pgo_bench.EDGE_CHUNK, device=device)
    order = cg.prepare_edge_order(lattice)
    cg_cfg = cg.CGConfig(gn_iterations=1, cg_iterations=CITY_CG, jac_chunk=pgo_bench.EDGE_CHUNK)
    n_chain, parts = SCHUR_CHAINS[-1]
    chain = pgo_bench.make_chain_graph(n_chain, device=device)
    chain_part = schur.partition_graph(chain, parts)

    def route_d():
        runner = SlamRunner(slam_config=mgr.get_by_name("slam"),
                            preprocessor_config=mgr.get_by_name("preprocessor"), device=device)
        assert runner.run(ListSource(msgs), ROUTE_D_TRACE_FRAMES) == ROUTE_D_TRACE_FRAMES

    def multi():
        runner = SlamRunner(slam_config=presets.multi_slam(MULTI_BEAMS, 8192, device=device),
                            preprocessor_config=multi_preprocessor(), base_frame="base_frame",
                            device=device, scan_topics=["/scan_0", "/scan_1"],
                            sensor_frames=list(MULTI_FRAMES))
        topics = ["/tf", "/odom", "/scan_0", "/scan_1"]
        n = runner.run(SynchronizedSource(ListSource(dual), topics, time_interval=0.1),
                       MULTI_TRACE_STEPS)
        assert n == MULTI_TRACE_STEPS

    out = {"corridor_chunked_dense": traced("corridor_chunked_dense", lambda: corridor_e2e.run_pass(
               "configurations/corridor.json", CHUNK, None, device, msgs)),
           f"route_d_{ROUTE_D_TRACE_FRAMES}": traced("route_d", route_d),
           f"multi_{MULTI_TRACE_STEPS}": traced("multi", multi),
           f"cg_lattice_{side}x{side}_one_gn": traced(
               "cg_lattice", lambda: cg.optimize_cg(cg_cfg, lattice, order)),
           f"schur_chain_{n_chain}_p{parts}_one_gn": traced(
               "schur_chain", lambda: schur.optimize_schur(pgo.PGOConfig(max_iterations=1),
                                                           chain, chain_part))}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "idle_shares.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def solvers_slice(msgs, slam_cfg, pcfg, device, dense: dict) -> dict:
    """Every part of phase 11."""
    return {"city_scale": city_scale_runs(device), "schur_chains": schur_chain_runs(device),
            "lm": lm_run(device),
            "corridor_solvers": corridor_solver_runs(msgs, slam_cfg, pcfg, device, dense),
            "finders": finder_runs(msgs, slam_cfg, pcfg, device),
            "idle_shares": idle_share_runs(msgs, device)}



# ---------------------------------------------------------------- phase 12

PORT_REST_FRAMES = 64               # track_sequence / ablate frames
ABLATE_REPS = 1
CORRIDOR_BEAMS = 1024               # the committed corridor log's beams
RAYCAST_NUMPY_STRIDE = 64           # every 64th pose against the numpy loop (45 poses)
RAYCAST_TOL_M = 1e-3
PREFETCH_FRAMES = 300
PREFETCH_POSE_TOL_M = 1e-6          # the same frames and ranges: the same poses
SHARDED_GRID_SIDE = 64              # 4,096 nodes: a 12,288-row dense Hessian
SHARDED_SCHUR_PARTS = 64
SHARDED_GN = 3
PORT_REST_DIR = "build/port_rest"   # the generated corridor log (too large for chiprun_out/)


def track_sequence_runs(msgs, slam_cfg, pcfg, device) -> dict:
    """(a) ``bench/pipeline.track_sequence`` on routes A and B over the first
    ``PORT_REST_FRAMES`` corridor frames from one populated state, against
    the same frames stepped one by one through ``track_step``; the aligner
    kernel launched once a tracked frame, counted from 0."""
    import dataclasses

    from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e, pipeline
    from srrg2_laser_slam_2d_tpu_torch.models import tracker as tr

    clouds, odoms = corridor_e2e.first_frames(msgs, PORT_REST_FRAMES, pcfg, device)
    odoms = torch.from_numpy(odoms).to(device)
    T = PORT_REST_FRAMES - 1
    rest, ov = clouds.map(lambda x: x[1:]), torch.ones(T, dtype=torch.bool, device=device)
    out = {}
    for route, kernel, flags in (("A", "banded_align_kernel", MESSAGE_ROUTES[0][1]),
                                 ("B", "projective_align_kernel", MESSAGE_ROUTES[3][1])):
        cfg = dataclasses.replace(slam_cfg.tracker, **flags)
        s0 = tr.populate(cfg, tr.init_state(cfg, device=device), pipeline.tree_index(clouds, 0))
        s0 = s0._replace(last_odom=odoms[0], has_odom=torch.ones((), dtype=torch.bool,
                                                                 device=device))
        reset_launches()
        t0 = time.perf_counter()
        fin, (poses, chi, inl) = pipeline.track_sequence(cfg, s0, rest, odoms[1:], ov)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        st, stepped = s0, []
        for k in range(T):
            st, _ = tr.track_step(cfg, st, pipeline.tree_index(rest, k), odoms[1 + k], ov[k])
            stepped.append(st.robot_in_local_map)
        diff = float((torch.stack(stepped) - poses).abs().max())
        out[route] = {"frames": T, "wall_s": wall, "ms_per_frame": wall / T * 1e3,
                      "max_abs_diff_to_stepped": diff,
                      "end_pose": poses[-1].cpu().tolist(),
                      "min_inliers": int(inl.min()),
                      "launches": {k: v for k, v in launches.items() if v}}
        log(f"track_sequence route {route}, {T} corridor frames: {json.dumps(out[route])}")
        assert torch.isfinite(poses).all() and diff <= 1e-4, (route, diff)
        assert launches[kernel] == T, (route, launches)
    return out


def ablate_run(device) -> dict:
    """(b) ``bench/ablate`` at ``--frames 64``, its rows to
    ``chiprun_out/ablate.json``; the launches of kernels 1, 4 and 5 summed
    over its rows."""
    from srrg2_laser_slam_2d_tpu_torch.bench import ablate

    reset_launches()
    out = ablate.main(["--frames", str(PORT_REST_FRAMES), "--reps", str(ABLATE_REPS),
                       "--json-out", os.path.join(OUT_DIR, "ablate.json"),
                       "--device", device.type])
    launches = read_launches()
    out["launches"] = {k: v for k, v in launches.items() if v}
    names = [r["name"] for r in out["rows"]]
    log(f"ablate: {len(names)} rows, launches {json.dumps(out['launches'])}")
    assert len(names) == 25 and all(
        np.isfinite(r.get("ms_per_frame", r.get("ms_per_call", np.nan))) for r in out["rows"])
    for k in ("frame_kernel", "projective_align_kernel", "banded_align_kernel"):
        assert launches[k] > 0, (k, launches)
    return out


def corridor_raycast(msgs, device) -> dict:
    """(c) The whole corridor drive ray-cast on the card at the committed
    log's 1,024 beams (2,871 poses), every ``RAYCAST_NUMPY_STRIDE``-th pose
    against the numpy loop on the host; then (d) ``synthetic_scene_generator
    --world corridors`` (the ray cast on the card, the noise drawn on the
    host) writes the log, whose ranges are held against the committed
    ``bench/data/corridor.jsonl`` and its odometry equal."""
    from srrg2_laser_slam_2d_tpu_torch.apps import synthetic_scene_generator as gen
    from srrg2_laser_slam_2d_tpu_torch.bench import synthetic
    from srrg2_laser_slam_2d_tpu_torch.io.messages import LaserMessage, OdometryMessage
    from srrg2_laser_slam_2d_tpu_torch.io.sources import JsonlFileSource
    from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection

    cfg = synthetic.CorridorConfig(num_beams=CORRIDOR_BEAMS)
    _, seg_a, seg_b = synthetic.corridor_geometry(cfg)
    proj = PolarProjection.make(
        cols=cfg.num_beams, angle_min=cfg.angle_min, angle_max=cfg.angle_max,
        range_min=cfg.range_min, range_max=cfg.range_max)
    poses = synthetic.corridor_trajectory(cfg)
    synthetic.raycast_ranges(proj, poses[:16], seg_a, seg_b, device)       # warm-up
    t0 = time.perf_counter()
    on_card = synthetic.raycast_ranges(proj, poses, seg_a, seg_b, device)
    card_s = time.perf_counter() - t0
    sub = poses[::RAYCAST_NUMPY_STRIDE]
    t0 = time.perf_counter()
    on_host = synthetic.raycast_ranges(proj, sub, seg_a, seg_b, "cpu")
    host_s = time.perf_counter() - t0
    card_sub = on_card[::RAYCAST_NUMPY_STRIDE]
    both = (card_sub > 0) & (on_host > 0)
    flips = int(((card_sub > 0) != (on_host > 0)).sum())
    out = {"poses": len(poses), "beams": cfg.num_beams, "segments": len(seg_a),
           "card_s": card_s, "numpy_poses": len(sub), "numpy_s": host_s,
           "numpy_s_per_pose": host_s / len(sub),
           "max_range_diff_m": float(np.abs(card_sub - on_host)[both].max()),
           "hit_miss_flips": flips, "beams_compared": int(on_host.size)}
    os.makedirs(PORT_REST_DIR, exist_ok=True)
    path = os.path.join(PORT_REST_DIR, "corridor_generated.jsonl")
    t0 = time.perf_counter()
    gen.main(["-m", path, "--world", "corridors", "--device", device.type])
    out["generator_s"] = time.perf_counter() - t0
    made = list(JsonlFileSource(path))
    rm = np.stack([np.asarray(m.ranges, np.float32) for m in made if isinstance(m, LaserMessage)])
    rc = np.stack([np.asarray(m.ranges, np.float32) for m in msgs if isinstance(m, LaserMessage)])
    om = np.stack([m.pose for m in made if isinstance(m, OdometryMessage)])
    oc = np.stack([m.pose for m in msgs if isinstance(m, OdometryMessage)])
    hit = (rm > 0) & (rc > 0)
    out["generated_vs_committed"] = {
        "messages": [len(made), len(msgs)], "max_range_diff_m": float(np.abs(rm - rc)[hit].max()),
        "hit_miss_flips": int(((rm > 0) != (rc > 0)).sum()), "beams": int(rc.size),
        "max_odometry_diff": float(np.abs(om - oc).max())}
    log(f"corridor ray cast on the card: {json.dumps(out)}")
    assert on_card.shape == (len(poses), cfg.num_beams) and np.isfinite(on_card).all()
    assert out["max_range_diff_m"] <= RAYCAST_TOL_M and flips <= 1e-3 * on_host.size, out
    g = out["generated_vs_committed"]
    assert len(made) == len(msgs) and rm.shape == rc.shape, g
    assert g["max_range_diff_m"] <= RAYCAST_TOL_M and g["hit_miss_flips"] <= 1e-3 * rc.size, g
    assert g["max_odometry_diff"] <= 1e-5, g
    os.remove(path)
    return out


def visual_apps_run(corridor_tum: str, device) -> dict:
    """(e) ``corridor_report`` on the corridor run's trajectory,
    ``visual_tests --stage all`` and ``param_reference``: each file there,
    the PNGs well formed."""
    from srrg2_laser_slam_2d_tpu_torch.apps import corridor_report, param_reference, visual_tests
    from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e

    report = corridor_report.main(["--gt", corridor_e2e.GROUND_TRUTH, "--est", corridor_tum,
                                   "-o", os.path.join(OUT_DIR, "corridor_report.png")])
    stages = visual_tests.main(["--stage", "all", "--outdir", os.path.join(OUT_DIR, "visual"),
                                "--device", device.type])
    md = os.path.join(OUT_DIR, "PARAMETERS.md")
    param_reference.main(["-o", md])
    out = {"corridor_report": png_check(report),
           "visual_tests": {os.path.basename(p): png_check(p) for p in stages},
           "param_reference_bytes": os.path.getsize(md)}
    log(f"visual apps: {json.dumps(out)}")
    assert len(stages) == 6 and all(v["bytes"] > 1000 for v in out["visual_tests"].values())
    assert out["param_reference_bytes"] > 1000
    return out


def native_baseline_run(corridor: dict) -> dict:
    """(f) The C++ baseline on the corridor on this host, beside the port's
    corridor run (the gated ``corridor.json`` run)."""
    from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e

    t0 = time.perf_counter()
    res = corridor_e2e.run_native_baseline()
    res["with_build_s"] = time.perf_counter() - t0
    res["port_corridor"] = {k: corridor[k] for k in ("wall_s", "ate_rmse_translation_m",
                                                     "gate_verdict", "closures")}
    log(f"native baseline on the corridor: {json.dumps(res)}")
    assert "error" not in res, res
    assert res["frames"] == 2871 and np.isfinite(res["ate_rmse_translation_m"])
    return res


def prefetch_route_d(msgs, slam_cfg, pcfg, device) -> dict:
    """(g) Route D over the first ``PREFETCH_FRAMES`` corridor frames with
    the laser ranges staged on the card by ``io/prefetch.DevicePrefetcher``,
    against the same run fed from host arrays: the same graph counters, the
    poses within ``PREFETCH_POSE_TOL_M``."""
    import copy

    from srrg2_laser_slam_2d_tpu_torch.io.messages import LaserMessage
    from srrg2_laser_slam_2d_tpu_torch.io.prefetch import DevicePrefetcher
    from srrg2_laser_slam_2d_tpu_torch.models.runner import SlamRunner

    lasers = [i for i, m in enumerate(msgs) if isinstance(m, LaserMessage)]
    head = msgs[:lasers[PREFETCH_FRAMES - 1] + 1]

    def staged():
        for i, m in enumerate(head):
            yield {"i": i, "ranges": (np.asarray(m.ranges, np.float32)
                                      if isinstance(m, LaserMessage) else None)}

    runs = {}
    for name in ("host", "prefetched"):
        runner = SlamRunner(slam_config=slam_cfg, preprocessor_config=pcfg, device=device)
        t0 = time.perf_counter()
        if name == "host":
            for m in head:
                runner.put_message(m)
        else:
            for item in DevicePrefetcher(staged(), depth=4, device=device):
                m = head[item["i"]]
                if item["ranges"] is not None:
                    assert item["ranges"].device.type == device.type
                    m = copy.copy(m)
                    m.ranges = item["ranges"]
                runner.put_message(m)
        torch.cuda.synchronize()
        slam = runner.slam
        runs[name] = {"wall_s": time.perf_counter() - t0, "frames": len(runner.trajectory),
                      "graph_variables": slam.num_variables(),
                      "graph_factors": slam.num_factors(), "closures": slam.num_closures,
                      "relocalizations": slam.relocalizations,
                      "poses": np.stack([p for _, p, _ in runner.trajectory])}
    h, p = runs["host"], runs["prefetched"]
    out = {name: {k: v for k, v in r.items() if k != "poses"} for name, r in runs.items()}
    out["max_pose_diff_m"] = float(np.abs(h["poses"][:, :2] - p["poses"][:, :2]).max())
    log(f"route D with the prefetcher, {PREFETCH_FRAMES} frames: {json.dumps(out)}")
    assert p["frames"] == h["frames"] == PREFETCH_FRAMES
    for k in ("graph_variables", "graph_factors", "closures", "relocalizations"):
        assert p[k] == h[k], (k, out)
    assert out["max_pose_diff_m"] <= PREFETCH_POSE_TOL_M, out
    return out


@contextlib.contextmanager
def nccl_world_of_one(device):
    """A one-rank NCCL process group for the collective path on one card."""
    import tempfile

    import torch.distributed as dist
    from srrg2_laser_slam_2d_tpu_torch.parallel import multihost

    with tempfile.TemporaryDirectory() as tmp:
        multihost.init_multiprocess(0, 1, "file://" + os.path.join(tmp, "rdv"), device=device)
        try:
            assert dist.get_backend() == "nccl"
            yield
        finally:
            dist.destroy_process_group()


@contextlib.contextmanager
def deterministic():
    """``index_add_`` on the card sums in a fixed order (not by atomics)."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def sharded_solver_runs(device) -> dict:
    """(i) ``optimize_sharded`` and ``optimize_schur_sharded`` at world size
    1 under NCCL against ``pgo.optimize`` and ``optimize_schur`` on the
    4,096-node lattice (``SHARDED_GN`` Gauss-Newton iterations; Schur at P =
    ``SHARDED_SCHUR_PARTS``): poses within 1e-4 and 1e-3, both sides with
    ``index_add_`` summing in a fixed order. With its atomic sums (the
    default) the single-device solver's own run-to-run spread is printed
    beside (3 iterations on a 12,288-row float32 system carry the sums'
    order to some 1e-3)."""
    from srrg2_laser_slam_2d_tpu_torch.bench import pgo_bench
    from srrg2_laser_slam_2d_tpu_torch.parallel import dist_pgo
    from srrg2_laser_slam_2d_tpu_torch.solver import pgo, schur

    graph = pgo_bench.make_grid_graph(SHARDED_GRID_SIDE, device=device)
    n = SHARDED_GRID_SIDE ** 2
    cfg = pgo.PGOConfig(max_iterations=SHARDED_GN)
    part = schur.partition_graph(graph, n_parts=SHARDED_SCHUR_PARTS, n_vars=n)
    pairs = {"dense": (lambda: dist_pgo.optimize_sharded(cfg, dist_pgo.shard_edges(graph), None),
                       lambda: pgo.optimize(cfg, graph)),
             "schur": (lambda: schur.optimize_schur_sharded(cfg, graph, part),
                       lambda: schur.optimize_schur(cfg, graph, part))}
    out = {"nodes": n, "hessian_rows": 3 * graph.var_capacity}

    def timed(fn):
        t0 = time.perf_counter()
        solved, chi, it = fn()
        sync(device)
        return time.perf_counter() - t0, solved.poses, float(chi), it

    for name, (sharded, single) in pairs.items():
        with deterministic():
            runs = [timed(sharded), timed(single)]
        atomic = [timed(single), timed(single)]
        out[name] = {"sharded_s": runs[0][0], "single_s": runs[1][0],
                     "iterations": [runs[0][3], runs[1][3]], "chi": [runs[0][2], runs[1][2]],
                     "max_pose_diff": float((runs[0][1] - runs[1][1]).abs().max()),
                     "atomic_sums_single_s": atomic[1][0],
                     "atomic_sums_spread": float((atomic[0][1] - atomic[1][1]).abs().max())}
    log(f"sharded solvers at world size 1 (NCCL; a correctness run, no scaling): "
        f"{json.dumps(out)}")
    assert out["dense"]["max_pose_diff"] <= 1e-4, out
    assert out["schur"]["max_pose_diff"] <= 1e-3, out
    return out


def port_rest_slice(msgs, slam_cfg, pcfg, device, corridor: dict, corridor_tum: str) -> dict:
    """Every part of phase 12."""
    from srrg2_laser_slam_2d_tpu_torch.parallel import dryrun, scaling

    out = {"track_sequence": track_sequence_runs(msgs, slam_cfg, pcfg, device),
           "ablate": ablate_run(device), "raycast": corridor_raycast(msgs, device),
           "visual_apps": visual_apps_run(corridor_tum, device),
           "native_baseline": native_baseline_run(corridor),
           "prefetch_route_d": prefetch_route_d(msgs, slam_cfg, pcfg, device)}
    with nccl_world_of_one(device):
        out["dryrun"] = dryrun.dryrun_multichip(1, device)
        assert out["dryrun"]["backend"] == "nccl"
        out["sharded_solvers"] = sharded_solver_runs(device)
        reset_launches()
        out["scaling"] = scaling.main(["--what", "all", "--device", device.type,
                                       "--out", os.path.join(OUT_DIR, "scaling.json")])
        out["scaling"]["launches"] = {k: v for k, v in read_launches().items() if v}
    log(f"scaling at world size 1 (no scaling measured): launches "
        f"{json.dumps(out['scaling']['launches'])}")
    assert out["scaling"]["launches"]["stream_kernel"] > 0
    assert all(len(out["scaling"][k]) == 1 for k in ("pgo", "align", "schur", "streams"))
    return out


# ------------------------------------------------ BOSS assemblies (phase 13)

BOSS_LASER0 = "tests/data/boss/laser0.boss.json"
BOSS_MULTI = "tests/data/boss/multi.boss.json"
BOSS_CARMEN_FRAMES = 100


def boss_chunked_run(corridor: dict) -> dict:
    """(a) The whole corridor through ``slam_app --boss-config`` with the
    LASER_0 assembly and ``--chunked 1024`` (``ChunkedGraphSLAM2D`` forces
    the frame kernel): 2,871 frames, the frame kernel once a chunk. The
    corridor gate belongs to ``corridor.json``, not to this tuning, so its
    verdict is printed beside phase 6's run, not asserted."""
    from srrg2_laser_slam_2d_tpu_torch.apps import slam_app
    from srrg2_laser_slam_2d_tpu_torch.bench import corridor_e2e

    args = slam_app.parser().parse_args([
        "--boss-config", BOSS_LASER0, "-i", corridor_e2e.DATA, "--scan-topic", "/scan",
        "--chunked", str(CHUNK)])
    reset_launches()
    t0 = time.perf_counter()
    rc, runner = slam_app.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    traj = np.stack([p for _, p, _ in runner.trajectory])
    stats, regression = ate_of(runner.trajectory)
    slam = runner.slam
    summary = {"graph_variables": slam.num_variables(), "graph_factors": slam.num_factors()}
    out = {"frames": len(traj), "wall_s": wall, "frames_per_s": len(traj) / wall,
           "phases": runner.timing_summary().get("phases", {}),
           "ate_rmse_translation_m": float(stats["rmse_translation"]),
           "gate_verdict": "REGRESSION" if regression else "PASS",
           "closures_accepted": corridor_e2e.closures_accepted(summary), **summary,
           "closures": slam.num_closures,
           "phase6_wall_s": corridor.get("wall_s"),
           "phase6_ate_rmse_translation_m": corridor.get("ate_rmse_translation_m"),
           "phase6_gate_verdict": corridor.get("gate_verdict"),
           "launches": {k: v for k, v in launches.items() if v}}
    log(f"BOSS LASER_0, slam_app --chunked {CHUNK}: {json.dumps(out)}")
    assert rc == 0 and traj.shape == (2871, 3) and np.isfinite(traj).all()
    assert launches["frame_kernel"] == -(-2871 // CHUNK), launches
    return out


def boss_multi_run(msgs, gt_poses, multi_loop: dict, device) -> dict:
    """(b) The MULTI assembly over phase 9's dual drive through
    ``SlamRunner(scan_topics=...)``, extrinsics from the TF tree: kernel 6
    once a tracked frame, finite poses, a graph that closes; its ATE beside
    phase 9's preset run."""
    from srrg2_laser_slam_2d_tpu_torch.io import boss_config
    from srrg2_laser_slam_2d_tpu_torch.io.sources import ListSource, SynchronizedSource
    from srrg2_laser_slam_2d_tpu_torch.models.runner import SlamRunner

    g = boss_config.load(BOSS_MULTI)
    runner = SlamRunner(slam_config=boss_config.to_slam_config(g),
                        preprocessor_config=boss_config.to_preprocessor_config(g),
                        scan_topics=["/scan_0", "/scan_1"], sensor_frames=list(MULTI_FRAMES),
                        base_frame="base_frame", device=device)
    topics = ["/tf", "/odom", "/scan_0", "/scan_1"]
    reset_launches()
    t0 = time.perf_counter()
    n = runner.run(SynchronizedSource(ListSource(msgs), topics, time_interval=0.1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    slam = runner.slam
    traj = np.stack([p for _, p, _ in runner.trajectory])
    gt_t = [m.timestamp for m in msgs if getattr(m, "topic", "") == "/scan_0"]
    out = {"frames": n, "wall_s": wall, "frames_per_s": n / wall,
           "tracker": type(slam.tracker).__name__, "tracked_frames": slam.tracker.steps,
           "preprocess_s": runner.preprocess_time,
           "phases": runner.timing_summary().get("phases", {}),
           "ate_rmse_translation_m": ate_vs(runner, gt_t, gt_poses),
           "graph_variables": slam.num_variables(), "graph_factors": slam.num_factors(),
           "closures": slam.num_closures, "relocalizations": slam.relocalizations,
           "phase9_wall_s": multi_loop.get("wall_s"),
           "phase9_ate_rmse_translation_m": multi_loop.get("ate_rmse_translation_m"),
           "launches": {k: v for k, v in launches.items() if v}}
    log(f"BOSS MULTI, SlamRunner(scan_topics=...) over the dual drive: {json.dumps(out)}")
    assert out["tracker"] == "MultiCueTracker"
    np.testing.assert_allclose(np.asarray(slam.cfg.cue_extrinsics), np.asarray(MULTI_EXTRINSICS),
                               atol=1e-6)
    assert launches["multicue_align_kernel"] == slam.tracker.steps > 0, launches
    assert n == MULTI_STEPS + 1 and traj.shape == (n, 3) and np.isfinite(traj).all()
    assert out["graph_factors"] > out["graph_variables"] - 1, out
    return out


def boss_message_run(carmen_path: str) -> dict:
    """(c) ``slam_app --boss-config`` with the LASER_0 assembly per message
    on phase 10's CARMEN log, its first ``BOSS_CARMEN_FRAMES`` frames: the
    plain ICP tracker (route C with the default z-buffer), so no kernel."""
    from srrg2_laser_slam_2d_tpu_torch.apps import slam_app

    args = slam_app.parser().parse_args([
        "--boss-config", BOSS_LASER0, "--carmen", carmen_path,
        "--max-frames", str(BOSS_CARMEN_FRAMES)])
    reset_launches()
    t0 = time.perf_counter()
    rc, runner = slam_app.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    traj = np.stack([p for _, p, _ in runner.trajectory])
    slam = runner.slam
    out = {"frames": len(traj), "wall_s": wall, "frames_per_s": len(traj) / wall,
           "mean_frame_hz": runner.timing_summary()["mean_frame_hz"],
           "preprocess_s": runner.preprocess_time,
           "phases": runner.timing_summary().get("phases", {}),
           "tracker": type(slam.tracker).__name__, "graph_variables": slam.num_variables(),
           "graph_factors": slam.num_factors(), "launches": launches}
    log(f"BOSS LASER_0, slam_app per message on the CARMEN log: {json.dumps(out)}")
    assert rc == 0 and traj.shape == (BOSS_CARMEN_FRAMES, 3) and np.isfinite(traj).all()
    assert out["tracker"] == "LaserTracker"
    assert not any(launches.values()), launches
    return out


def boss_slice(corridor: dict, drive, multi_loop: dict, carmen_path: str, device) -> dict:
    """Every part of phase 13."""
    return {"chunked_laser0": boss_chunked_run(corridor),
            "multi": boss_multi_run(*drive, multi_loop, device),
            "per_message_laser0": boss_message_run(carmen_path)}


def port_rest_corridor(msgs, device) -> tuple[dict, str]:
    """The gated corridor run for ``--only port-rest`` (phase 6's in the
    whole script) and its trajectory as a TUM file."""
    summary, runner = corridor_run("configurations/corridor.json", msgs, device)
    return summary, write_corridor_tum(runner)


def write_corridor_tum(runner) -> str:
    from srrg2_laser_slam_2d_tpu_torch.io import tum

    path = os.path.join(OUT_DIR, "corridor.tum")
    os.makedirs(OUT_DIR, exist_ok=True)
    tum.write_tum(path, [t for t, _, _ in runner.trajectory], [p for _, p, _ in runner.trajectory])
    return path


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on one NVIDIA card.")
    ap.add_argument("--only", choices=["message-kernels", "message-path", "multi", "slam-app",
                                       "solvers", "port-rest", "boss", "materialize"],
                    default=None,
                    help="while developing: run the build and this part alone; "
                         "prints no result lines")
    args = ap.parse_args()
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

    if args.only == "multi":
        multi_path(device)
        return 0
    if args.only == "materialize":
        check_materialize_kernel(device)
        return 0
    if args.only == "slam-app":
        slam_app_slice({"ate_rmse_translation_m": None}, device)
        return 0
    mgr = config_mod.ConfigManager.read("configurations/corridor.json")
    slam_cfg, pcfg = mgr.get_by_name("slam"), mgr.get_by_name("preprocessor")
    msgs = corridor_e2e.load_messages()
    if args.only == "message-kernels":
        check_message_kernels(msgs, slam_cfg, pcfg, device)
        return 0
    if args.only == "message-path":
        routes_in_one_map(slam_cfg, pcfg, msgs, device)
        message_routes_run(slam_cfg, pcfg, msgs, device)
        route_d_run(msgs)
        return 0
    if args.only == "solvers":
        solvers_slice(msgs, slam_cfg, pcfg, device, {})
        return 0
    if args.only == "port-rest":
        port_rest_slice(msgs, slam_cfg, pcfg, device, *port_rest_corridor(msgs, device))
        return 0
    if args.only == "boss":
        boss_slice({}, dual_drive(device), {}, carmen_log(device), device)
        return 0
    stream_entry = check_stream_kernel(device)
    kernels = [check_frame_kernel(msgs, slam_cfg, pcfg, device),
               check_nn_icp_kernel(slam_cfg.detector, device), stream_entry,
               *check_message_kernels(msgs, slam_cfg, pcfg, device),
               check_materialize_kernel(device)]

    def stamp(phase: str) -> None:
        log(f"[{time.perf_counter() - t_start:.1f} s] {phase} done")

    stamp("kernel checks")
    capture = DetectionCapture()
    main_run, main_runner = corridor_run("configurations/corridor.json", msgs, device, capture)
    corridor_tum = write_corridor_tum(main_runner)
    lean_run, _ = corridor_run("configurations/corridor_lean.json", msgs, device)
    kernels[1]["corridor_batch"] = check_nn_icp_corridor(capture.batch)
    projective_run = corridor_projective_run(msgs, device, main_run)
    stamp("corridor")
    throughput = headline_run(device)
    stamp("throughput")
    one_map = routes_in_one_map(slam_cfg, pcfg, msgs, device)
    routes = message_routes_run(slam_cfg, pcfg, msgs, device)
    stamp("per-message routes")
    route_d = route_d_run(msgs)
    stamp("route D")
    multi = multi_path(device)
    stamp("MULTI path")
    slice10 = slam_app_slice(main_run, device)
    stamp("slam_app slice")
    slice11 = solvers_slice(msgs, slam_cfg, pcfg, device, main_run)
    stamp("solvers slice")
    slice12 = port_rest_slice(msgs, slam_cfg, pcfg, device, main_run, corridor_tum)
    stamp("last modules")
    slice13 = boss_slice(main_run, multi.pop("drive"), multi["multi_loop"]["dual"],
                         slice10["carmen_log"], device)
    stamp("BOSS assemblies")
    # each kernel's launches on ITS main path, counted from 0 over that path
    by_route = {r["route"]: r["launches"] for r in routes}
    launches = {**main_run["launches"], **throughput["launches"],
                "banded_align_kernel": by_route["A"]["banded_align_kernel"],
                "projective_align_kernel": by_route["B"]["projective_align_kernel"],
                "scene_kernel": by_route["B"]["scene_kernel"],
                "projector_kernel": by_route["C kernel z-buffer"]["projector_kernel"]}
    assert route_d["launches"]["frame_kernel"] > 0
    for k in kernels:
        k["launches"] = launches[k["name"]]
    # the materialize kernel: the corridor's launches above, the throughput
    # path's beside them, and the calls of both by scenes x frames
    for k in kernels:
        if k["name"] == "materialize_kernel":
            k["throughput_launches"] = throughput["launches"]["materialize_kernel_throughput"]
            k["calls"] = {"corridor": main_run["materialize_calls"],
                          "throughput": throughput["materialize_calls"]}
    # kernel 6: the MULTI loop; the probes: their own probe runs
    kernels += multi["kernels"]
    for k in kernels:
        assert k["launches"] > 0, f"{k['name']} was not launched on its main path"
    # what phase 10 adds: kernels 1 and 2 through slam_app, kernel 1 per CARMEN message
    for part in ("slam_app_corridor", "carmen_per_message"):
        for k in kernels:
            if k["name"] in slice10[part]["launches"]:
                k[f"{part}_launches"] = slice10[part]["launches"][k["name"]]
    # what phase 11 adds: kernels 1 and 2 through the corridor on the cg and schur solvers
    for kind, run in slice11["corridor_solvers"].items():
        for k in kernels:
            if k["name"] in run["launches"]:
                k[f"corridor_{kind}_launches"] = run["launches"][k["name"]]

    # what phase 12 adds: kernels 5 and 4 through track_sequence, 1, 4 and 5
    # through ablate, 3 through the scaling harness
    for part, launched in (
            ("track_sequence", {k: v for r in slice12["track_sequence"].values()
                                for k, v in r["launches"].items()}),
            ("ablate", slice12["ablate"]["launches"]),
            ("scaling", slice12["scaling"]["launches"])):
        for k in kernels:
            if k["name"] in launched:
                k[f"{part}_launches"] = launched[k["name"]]
    # what phase 13 adds: kernel 1 through the LASER_0 assembly under
    # --chunked, kernel 6 through the MULTI assembly
    for part in ("chunked_laser0", "multi"):
        for k in kernels:
            if k["name"] in slice13[part]["launches"]:
                k[f"boss_{part}_launches"] = slice13[part]["launches"][k["name"]]

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "corridor": main_run,
                   "corridor_lean": lean_run, "corridor_projective": projective_run,
                   "throughput": throughput,
                   "per_message": {"route_d": route_d, "routes": routes,
                                   "one_local_map": one_map},
                   "multicue_bench": multi["multicue_bench"], "multi_loop": multi["multi_loop"],
                   "slam_app": slice10, "solvers": slice11, "port_rest": slice12,
                   "boss": slice13,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    keys += ("throughput_launches", "calls")
    log(json.dumps({"kernels": [{k: kern[k] for k in keys if k in kern} for kern in kernels]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
