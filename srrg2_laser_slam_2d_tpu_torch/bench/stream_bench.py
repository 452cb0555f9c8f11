"""Throughput per card: K independent tracking streams through the K-stream
frame kernel (``ops/stream_kernel.py``) against the single-stream frame
kernel (``ops/frame_kernel.py``). Counterpart of
``srrg2_laser_slam_2d_tpu/bench/stream_bench.py``.

One 721-beam scan cannot fill a card: a stream's frames are a sequential
chain on one block. Aggregate scans per second come from running K streams
as K blocks of one launch. Per stream the work is that of the single-stream
kernel, every stream's scene materialization included. As in the JAX
benchmark, one stream's data is broadcast to all K streams; the tests and
``chip_smoke.py`` compare the kernel on K different streams.

Each measurement chains ``CHAIN`` calls with the state fed back and
synchronises once, the way a serving loop consumes the kernel; the best of
``reps`` runs counts. With ``parts=True`` ``measure_streams`` also times the
two halves of one such call on the same inputs, the kernel launch and the
scene materializations (the ``parts`` of each K's output, which the JAX
benchmark does not have).

Usage (the CUDA card by default; without one it raises):
  python -m srrg2_laser_slam_2d_tpu_torch.bench.stream_bench [--frames 256]
      [--ks 8,32,128] [--out stream.json] [--device cuda]
      [--window 128] [--corr-refresh 2] [--stream-gather onehot]
Prints one JSON object per K, then the whole result as one JSON object. The
last three options change one setting of the kernel's spec (the defaults are
the JAX benchmark's serving settings) to see what it is worth on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from .._device import card_description, resolve_device

CHAIN = 10


def build_inputs(frames: int, num_beams: int = 721, device=None, seed: int = 0):
    """One synthetic stream of ``frames`` scans -> (spec, state0 seeded from
    the first scan, measC [frames - 1, 8, B] canvases without odometry
    lanes, odoms [frames - 1, 3])."""
    from ..models import fast_tracker as ft
    from ..models.preprocessor import PreprocessorConfig
    from ..ops.frame_kernel import FrameSpec
    from ..ops.projector import PolarProjection
    from . import pipeline, synthetic

    device = resolve_device(device)
    ds = synthetic.simulate(
        synthetic.SyntheticConfig(steps=frames - 1, num_beams=num_beams, seed=seed), device)
    pcfg = PreprocessorConfig(voxelize_resolution=0.02, normal_window=8)
    match_proj = PolarProjection.make(cols=num_beams, angle_min=-np.pi, angle_max=np.pi,
                                      range_min=0.3, range_max=20.0)
    # window=128 and corr_refresh=2 are the JAX benchmark's serving settings
    spec = FrameSpec(scene_capacity=4096, projection=match_proj, iterations=10,
                     odom_weight=1.0, meas_as_canvas=True, window=128, corr_refresh=2)
    meas_stack = pipeline.preprocess_batch(ds.projection, pcfg,
                                           torch.from_numpy(ds.ranges).to(device))
    odoms = torch.from_numpy(ds.robot_poses).to(device)
    state0 = ft.seed(spec, meas_stack.map(lambda x: x[0]),
                     np.array(ds.config.sensor_in_robot, np.float32),
                     odom=ds.robot_poses[0])
    measC = ft.pack_measurement_canvas_batch(spec, meas_stack.map(lambda x: x[1:]))
    return spec, state0, measC, odoms[1:]


def build_different_streams(frames: int, k: int, num_beams: int = 721, device=None,
                            first_seed: int = 17):
    """K DIFFERENT streams (seeds ``first_seed`` + i) packed for the K-stream
    kernel -> (spec, per-stream seed states, cacheB, poseB, measC_stack,
    odom_stack). The measurements broadcast one stream, so a kernel that
    read stream 0 for every block would pass there; comparisons use this."""
    from ..ops import stream_kernel as sk

    per = [build_inputs(frames, num_beams, device, seed=first_seed + i) for i in range(k)]
    cacheB, poseB = sk.pack_stream_state(torch.stack([p[1].cacheT for p in per]),
                                         torch.stack([p[1].pose for p in per]))
    measC_stack, odom_stack = sk.pack_stream_measurements(
        torch.stack([p[2] for p in per]), torch.stack([p[3] for p in per]))
    return per[0][0], [p[1] for p in per], cacheB, poseB, measC_stack, odom_stack


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_best(fn, reps: int = 5) -> float:
    """Best wall time of ``fn`` (which ends synchronised) over ``reps`` runs
    after one warm-up run (kernel build and first use)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def measure_single(spec, state0, measC, odoms, chain: int = CHAIN, reps: int = 5) -> dict:
    """The single-stream frame kernel over the stack, scene materialized."""
    from ..models import fast_tracker as ft

    T = measC.shape[0]
    measF = measC.clone()
    measF[:, 6, 0:3] = odoms
    measF[:, 6, 3] = 1.0

    def run():
        st = state0
        for _ in range(chain):
            st, _stats = ft.track_sequence_fast(spec, st, measF)
        _sync(measF.device)
        return st

    best = time_best(run, reps)
    return {"frames": T * chain, "chained_calls": chain, "seconds": best,
            "scans_per_sec": T * chain / best}


def _broadcast(state0, measC, odoms, k: int):
    """One stream's state and data broadcast to K streams, packed:
    (cacheB, poseB, measC_stack, odom_stack, sceneK)."""
    from ..ops import stream_kernel as sk

    cacheB, poseB = sk.pack_stream_state(
        state0.cacheT.expand((k,) + state0.cacheT.shape),
        state0.pose.expand((k,) + state0.pose.shape))
    measC_stack, odom_stack = sk.pack_stream_measurements(
        measC.expand((k,) + measC.shape), odoms.expand((k,) + odoms.shape))
    sceneK = state0.scene.map(lambda x: x.expand((k,) + x.shape))
    return cacheB, poseB, measC_stack, odom_stack, sceneK


def measure_streams(spec, state0, measC, odoms, k: int, chain: int = CHAIN,
                    reps: int = 5, parts: bool = False) -> dict:
    """The K-stream kernel with one stream's data broadcast to all K, every
    stream's scene materialized (the same work per stream as
    ``measure_single``). ``parts`` adds where one call spends its time: the
    kernel launch alone and the K scene materializations alone, each ending
    synchronised (milliseconds, best of ``reps``)."""
    from ..models import fast_tracker as ft
    from ..ops import stream_kernel as sk

    T = measC.shape[0]
    cacheB, poseB, measC_stack, odom_stack, sceneK = _broadcast(state0, measC, odoms, k)

    def run():
        cB, pB = cacheB, poseB
        for _ in range(chain):
            cB, pB, payB = sk.track_streams_grid(spec, cB, pB, measC_stack, odom_stack)
            scenes = ft.materialize(spec, sceneK, payB.movedim(2, 0), pB[:, 7])
        _sync(measC.device)
        return pB, scenes

    best = time_best(run, reps)
    result = {"k": k, "frames_per_stream": T * chain, "chained_calls": chain,
              "seconds": best, "aggregate_scans_per_sec": k * T * chain / best,
              "per_stream_scans_per_sec": T * chain / best}
    if parts:
        _, pB, payB = sk.track_streams_grid(spec, cacheB, poseB, measC_stack, odom_stack)

        def kernel_only():
            sk.track_streams_grid(spec, cacheB, poseB, measC_stack, odom_stack)
            _sync(measC.device)

        def scenes_only():
            ft.materialize(spec, sceneK, payB.movedim(2, 0), pB[:, 7])
            _sync(measC.device)

        result["parts"] = {"kernel_ms": 1e3 * time_best(kernel_only, reps),
                           "materialize_ms": 1e3 * time_best(scenes_only, reps)}
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--ks", type=str, default="8,32,128")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the "
                         "plain PyTorch versions, use few frames)")
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--corr-refresh", type=int, default=None)
    ap.add_argument("--stream-gather", choices=("onehot", "roll"), default=None)
    args = ap.parse_args()

    device = resolve_device(args.device)
    spec, state0, measC, odoms = build_inputs(args.frames, device=device)
    changed = {name: getattr(args, name) for name in ("window", "corr_refresh", "stream_gather")
               if getattr(args, name) is not None}
    spec = dataclasses.replace(spec, **changed)
    result = {
        "card": card_description(device),
        "num_beams": int(spec.projection.cols),
        "gn_iterations": spec.iterations,
        "window": spec.window, "corr_refresh": spec.corr_refresh,
        "stream_gather": spec.stream_gather,
        "single_stream": measure_single(spec, state0, measC, odoms),
        "streams": [],
    }
    for k in [int(s) for s in args.ks.split(",") if s]:
        result["streams"].append(measure_streams(spec, state0, measC, odoms, k, parts=True))
        print(json.dumps(result["streams"][-1]), flush=True)

    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
