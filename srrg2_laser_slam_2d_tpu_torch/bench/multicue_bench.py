"""Dual-rangefinder tracking throughput: the MULTI assembly's tracker, one
dual-laser message pack per frame. Counterpart of
``srrg2_laser_slam_2d_tpu/bench/multicue_bench.py``, with the same inputs
and three rates:

  - ``dual_cue_fused_scans_per_sec``: ``track_step_multi`` with the
    multi-cue aligner kernel (``use_fused_aligner``, the default on a card);
  - ``dual_cue_plain_scans_per_sec``: the same step through the plain
    ``icp.align_multi``;
  - ``single_cue_plain_scans_per_sec``: the single-cue ``track_step`` with
    the plain ICP on the front laser alone (what the second cue costs).

Inputs: a front (0.2, 0, 0) and a rear (-0.2, 0, pi) laser of one synthetic
drive, ``--frames`` scans of 721 beams each, preprocessed with voxel 0.02
and normal window 8; canvas 721 beams over +-pi, ranges 0.3-20 m; scene
8,192 rows; 10 Gauss-Newton iterations, point distance 0.5, normal cos 0.8.
The JAX benchmark scans the frames inside one device program; here each
measurement runs the frames - 1 steps as a Python loop ``--chain`` times
with the state fed back and synchronises once at the end, best of
``--reps`` after one warm-up. ``kernel_ms`` is one launch of the kernel
alone on the first step's inputs (CUDA events over 100 launches) and
``kernel_share`` its part of a fused step.

Usage (the CUDA card by default; without one it raises):
  python -m srrg2_laser_slam_2d_tpu_torch.bench.multicue_bench [--frames 256]
      [--chain 10] [--reps 3] [--out multicue.json] [--device cuda]
``--device cpu --frames 4 --chain 1 --reps 1`` rehearses the plain path on
the host. Prints each rate as it is measured, then one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .._device import card_description, resolve_device
from .corridor_e2e import _commit

FRONT = (0.2, 0.0, 0.0)
REAR = (-0.2, 0.0, float(np.pi))
ITERATIONS = 10


def build_inputs(frames: int = 256, num_beams: int = 721, device=None) -> dict:
    """Both lasers' preprocessed scans on ``device``: ``meas`` [frames, 2,
    N, ...] (front, rear), ``front`` [frames, N, ...], ``odoms`` [frames, 3]
    (the ground truth), ``extrinsics`` [2, 3]."""
    from ..models.preprocessor import PreprocessorConfig
    from ..utils.cloud import Cloud
    from . import pipeline, synthetic

    device = resolve_device(device)
    pcfg = PreprocessorConfig(voxelize_resolution=0.02, normal_window=8)
    clouds, poses = [], None
    for extr in (FRONT, REAR):
        ds = synthetic.simulate(synthetic.SyntheticConfig(
            steps=frames - 1, num_beams=num_beams, sensor_in_robot=extr), device)
        clouds.append(pipeline.preprocess_batch(
            ds.projection, pcfg, torch.from_numpy(ds.ranges).to(device)))
        poses = ds.robot_poses
    return {"num_beams": num_beams,
            "meas": Cloud(*(torch.stack(f, dim=1) for f in zip(*clouds))),
            "front": clouds[0],
            "odoms": torch.from_numpy(poses).to(device),
            "extrinsics": torch.tensor([FRONT, REAR], dtype=torch.float32, device=device)}


def tracker_config(fused: bool, num_beams: int = 721):
    from ..models import tracker as tracker_mod
    from ..ops import icp
    from ..ops.projector import PolarProjection

    proj = PolarProjection.make(cols=num_beams, angle_min=-np.pi, angle_max=np.pi,
                                range_min=0.3, range_max=20.0)
    return tracker_mod.TrackerConfig(
        scene_capacity=8192, projection=proj,
        aligner=icp.AlignerConfig(max_iterations=ITERATIONS, point_distance=0.5,
                                  normal_cos=0.8),
        use_fused_aligner=fused)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_rate(run, steps: int, chain: int, reps: int, device) -> float:
    """Frames per second of ``run`` (one pass over the steps), chained
    ``chain`` times with one synchronisation, best of ``reps``."""
    run()
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(chain):
            run()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return steps * chain / best


def measure_multi(inputs: dict, fused: bool, chain: int = 10, reps: int = 3) -> float:
    """Dual-cue scans per second of ``track_step_multi``."""
    from ..models import tracker as tracker_mod

    meas, odoms, extr = inputs["meas"], inputs["odoms"], inputs["extrinsics"]
    dev = odoms.device
    cfg = tracker_config(fused, inputs["num_beams"])
    state0 = tracker_mod.populate_multi(cfg, tracker_mod.init_state(cfg, device=dev),
                                        meas.map(lambda x: x[0]), extr)
    valid = torch.ones((), dtype=torch.bool, device=dev)
    steps = odoms.shape[0] - 1

    def run():
        st = state0
        for t in range(1, steps + 1):
            st, _ = tracker_mod.track_step_multi(cfg, st, meas.map(lambda x: x[t]), extr,
                                                 odoms[t], valid)
        return st

    return _best_rate(run, steps, chain, reps, dev)


def measure_single(inputs: dict, chain: int = 10, reps: int = 3) -> float:
    """Single-cue (front laser) scans per second of ``track_step`` with the
    plain ICP."""
    from ..models import tracker as tracker_mod

    front, odoms = inputs["front"], inputs["odoms"]
    dev = odoms.device
    cfg = tracker_config(False, inputs["num_beams"])
    state0 = tracker_mod.populate(
        cfg, tracker_mod.init_state(cfg, sensor_in_robot=FRONT, device=dev),
        front.map(lambda x: x[0]))
    valid = torch.ones((), dtype=torch.bool, device=dev)
    steps = odoms.shape[0] - 1

    def run():
        st = state0
        for t in range(1, steps + 1):
            st, _ = tracker_mod.track_step(cfg, st, front.map(lambda x: x[t]), odoms[t], valid)
        return st

    return _best_rate(run, steps, chain, reps, dev)


def kernel_inputs(inputs: dict) -> tuple[tuple, dict]:
    """The multi-cue aligner kernel's arguments at the first tracked step
    (the scene seeded from frame 0, frame 1's measurements, the odometry
    step as initial guess and prior), built by ``track_step_multi``'s own
    helpers."""
    from ..models import tracker as tracker_mod

    meas, odoms, extr = inputs["meas"], inputs["odoms"], inputs["extrinsics"]
    cfg = tracker_config(True, inputs["num_beams"])
    st = tracker_mod.populate_multi(cfg, tracker_mod.init_state(cfg, device=odoms.device),
                                    meas.map(lambda x: x[0]), extr)
    st = st._replace(last_odom=odoms[0], has_odom=torch.ones_like(st.has_odom))
    moving, T0 = tracker_mod.multi_step_inputs(cfg, st, extr, odoms[1], st.has_odom)
    return tracker_mod.fused_multi_arguments(cfg, meas.map(lambda x: x[1]), extr, moving, T0)


def measure_kernel_ms(inputs: dict, launches: int = 100) -> float:
    """Milliseconds of one launch of the multi-cue aligner kernel alone
    (CUDA events around ``launches`` launches, after one warm-up)."""
    from ..ops.multicue_align_kernel import fused_projective_align_multi

    args, kw = kernel_inputs(inputs)

    def call():
        fused_projective_align_multi(*args, **kw)

    call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def run(frames: int = 256, num_beams: int = 721, chain: int = 10, reps: int = 3,
        device=None) -> dict:
    """The three rates (and on a card the kernel's time alone and its share
    of a fused step, and the kernel's launches during the fused rate)."""
    from ..ops import multicue_align_kernel as mak

    device = resolve_device(device)
    inputs = build_inputs(frames, num_beams, device)
    result = {"card": card_description(device), "commit": _commit(), "frames": frames,
              "beams_per_cue": num_beams, "gn_iterations": ITERATIONS,
              "chained_passes": chain, "best_of": reps,
              "methodology": f"{frames - 1} tracking steps in a Python loop, {chain} chained "
                             f"passes, one synchronisation, best of {reps} after a warm-up"}
    before = mak.launches
    result["dual_cue_fused_scans_per_sec"] = measure_multi(inputs, True, chain, reps)
    result["kernel_launches"] = mak.launches - before
    print("dual_cue_fused_scans_per_sec", result["dual_cue_fused_scans_per_sec"], flush=True)
    result["dual_cue_plain_scans_per_sec"] = measure_multi(inputs, False, chain, reps)
    print("dual_cue_plain_scans_per_sec", result["dual_cue_plain_scans_per_sec"], flush=True)
    result["single_cue_plain_scans_per_sec"] = measure_single(inputs, chain, reps)
    print("single_cue_plain_scans_per_sec", result["single_cue_plain_scans_per_sec"],
          flush=True)
    if device.type == "cuda":
        result["kernel_ms"] = measure_kernel_ms(inputs)
        result["fused_step_ms"] = 1e3 / result["dual_cue_fused_scans_per_sec"]
        result["kernel_share"] = result["kernel_ms"] / result["fused_step_ms"]
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--beams", type=int, default=721)
    ap.add_argument("--chain", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions, use few frames)")
    args = ap.parse_args()
    result = run(args.frames, args.beams, args.chain, args.reps, args.device)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
