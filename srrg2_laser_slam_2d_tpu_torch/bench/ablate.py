"""Per-component ablation of the tracking step (counterpart of
``srrg2_laser_slam_2d_tpu/bench/ablate.py``, the same rows).

Run: python -m srrg2_laser_slam_2d_tpu_torch.bench.ablate [--frames 64] [--cap 4096]
         [--reps 5] [--json-out rows.json] [--device cpu]

Rows, all from ONE process (compare rows only within one run):
  - the whole step through ``bench/pipeline.track_sequence`` in each tracker
    configuration (plain; the dense or the banded aligner kernel, each with
    canvas reuse and the lean scene ops);
  - the dense and the banded aligner kernels alone (32 chained calls);
  - the lean merge alone;
  - the frame kernel through ``track_sequence_fast``, through the grid with
    no scene, with pre-packed canvases and a 128-beam window, and with the
    packing timed too; the grid at 1, 5, 10 and 20 Gauss-Newton iterations
    and at ``merge_shift`` 8, 16, 32 and 64 (runtime fields of the kernel's
    parameter block: no rebuild);
  - a no-op loop floor and the plain merge alone.

On a CUDA device each row is N calls enqueued back to back with ONE
synchronisation at the end, after one warm-up call (``bench/stream_bench``'s
pattern; a per-call synchronisation would time the host). On the CPU only the
rows that the JAX module runs off its accelerator are run (the plain step and
the plain merge), as a rehearsal: CPU times are not device numbers. Each row
also records the kernel launches it made (warm-up included).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

CHAIN = 32          # chained calls of one component row (the JAX scans' length)
NOOP_CHAIN = 64


def _launch_modules():
    from ..ops import (banded_align_kernel, frame_kernel, projective_align_kernel,
                       projector_kernel, scene_kernel)
    return {"frame_kernel": frame_kernel, "projective_align_kernel": projective_align_kernel,
            "banded_align_kernel": banded_align_kernel, "scene_kernel": scene_kernel,
            "projector_kernel": projector_kernel}


def _launches() -> dict:
    return {k: m.launches for k, m in _launch_modules().items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Rows:
    """The ablation's rows: each timed as ``reps`` calls after one warm-up,
    one synchronisation at the end."""

    def __init__(self, device: torch.device, reps: int):
        self.device, self.reps, self.rows = device, reps, []

    def time(self, name: str, fn, per: int, unit: str) -> dict:
        before = _launches()
        fn()
        _sync(self.device)
        t0 = time.perf_counter()
        for _ in range(self.reps):
            fn()
        _sync(self.device)
        dt = (time.perf_counter() - t0) / self.reps
        after = _launches()
        row = {"name": name, f"ms_per_{unit}": dt / per * 1e3, "calls": self.reps,
               "launches": {k: after[k] - before[k] for k in after if after[k] > before[k]}}
        line = f"{name:42s} {dt / per * 1e3:7.3f} ms/{unit}"
        if unit == "frame":
            row["scans_per_s"] = per / dt
            line += f"   {per / dt:8.0f} scans/s"
        print(line, flush=True)
        self.rows.append(row)
        return row


def run(frames: int = 64, cap: int = 4096, reps: int = 5, device=None) -> dict:
    """Every row of the ablation on ``device``; returns the result dict."""
    from .._device import card_description, resolve_device
    from ..models import fast_tracker as ft
    from ..models import tracker as tracker_mod
    from ..models.preprocessor import PreprocessorConfig
    from ..ops import clip as clip_op
    from ..ops import icp
    from ..ops import merge as merge_op
    from ..ops.frame_kernel import FrameSpec, track_frames_grid
    from ..ops.projector import PolarProjection
    from . import pipeline, synthetic

    device = resolve_device(device)
    on_card = device.type == "cuda"
    print(f"device={card_description(device)}", flush=True)
    num_beams = 721
    ds = synthetic.simulate(synthetic.SyntheticConfig(steps=frames - 1, num_beams=num_beams),
                            device)
    pcfg = PreprocessorConfig(voxelize_resolution=0.02, normal_window=8)
    match_proj = PolarProjection.make(cols=num_beams, angle_min=-np.pi, angle_max=np.pi,
                                      range_min=0.3, range_max=20.0)
    meas_stack = pipeline.preprocess_batch(ds.projection, pcfg,
                                           torch.from_numpy(ds.ranges).to(device))
    odoms = torch.from_numpy(ds.robot_poses).to(device)
    odom_valid = torch.ones(len(ds.ranges), dtype=torch.bool, device=device)
    n_frames = len(ds.ranges)
    sir = np.array(ds.config.sensor_in_robot, np.float32)
    meas0 = pipeline.tree_index(meas_stack, 1)
    rows = Rows(device, reps)

    def run_cfg(name, **kw):
        tcfg = tracker_mod.TrackerConfig(
            scene_capacity=cap, projection=match_proj,
            aligner=icp.AlignerConfig(max_iterations=10, point_distance=0.5, normal_cos=0.8),
            **kw)
        state0 = tracker_mod.init_state(tcfg, sensor_in_robot=sir, device=device)
        state0 = tracker_mod.populate(tcfg, state0, pipeline.tree_index(meas_stack, 0))
        rows.time(name, lambda: pipeline.track_sequence(tcfg, state0, meas_stack, odoms,
                                                        odom_valid), n_frames, "frame")

    run_cfg("xla full step", use_fused_aligner=False)
    if on_card:
        run_cfg("fused align", use_fused_aligner=True)
        run_cfg("banded align", use_fused_aligner=True, banded_aligner=True)
        run_cfg("fused align + canvas reuse (bench cfg)",
                use_fused_aligner=True, reuse_clip_canvas=True)
        run_cfg("banded align + canvas reuse",
                use_fused_aligner=True, banded_aligner=True, reuse_clip_canvas=True)
        run_cfg("banded align + lean scene ops", use_fused_aligner=True, banded_aligner=True,
                reuse_clip_canvas=True, lean_scene_ops=True)
        run_cfg("fused align + lean scene ops",
                use_fused_aligner=True, reuse_clip_canvas=True, lean_scene_ops=True)
        run_cfg("xla align + lean scene ops",
                use_fused_aligner=False, reuse_clip_canvas=True, lean_scene_ops=True)

    tcfg = tracker_mod.TrackerConfig(scene_capacity=cap, projection=match_proj)
    state0 = tracker_mod.init_state(tcfg, sensor_in_robot=sir, device=device)
    state0 = tracker_mod.populate(tcfg, state0, pipeline.tree_index(meas_stack, 0))
    scene = state0.scene
    step = torch.tensor([0.01, 0.0, 0.001], device=device)

    if on_card:
        from ..ops.banded_align_kernel import fused_projective_align_banded
        from ..ops.projective_align_kernel import fused_projective_align

        clipped = clip_op.clip_projective(match_proj, scene, state0.robot_in_local_map,
                                          state0.sensor_in_robot, 0.0)

        def align_chain(fn):
            def go():
                T = torch.zeros(3, device=device)
                for _ in range(CHAIN):
                    T = fn(match_proj, meas0.xy, meas0.normal, meas0.valid, clipped.xy,
                           clipped.normal, clipped.valid, T, iterations=10,
                           odom_weight=1.0).estimate
                return T
            return go

        rows.time("fused align kernel alone (10 it)", align_chain(fused_projective_align),
                  CHAIN, "call")
        rows.time("banded align kernel alone (10 it)",
                  align_chain(fused_projective_align_banded), CHAIN, "call")

        # the lean merge alone: the beam-indexed clip stands in for the canvas
        canvas_rows = torch.arange(match_proj.cols, device=device)

        def lean_chain():
            sc, cc, rr = scene, clipped, canvas_rows
            for _ in range(CHAIN):
                sc, cc, rr = merge_op.merge_projective_lean(
                    match_proj, sc, cc, rr, meas0, old_sensor_in_new=step,
                    measurement_in_scene=step)
            return sc

        rows.time("lean merge alone (xla)", lean_chain, CHAIN, "call")

        # the frame kernel: one launch for the whole sequence, scene deferred
        spec = FrameSpec(scene_capacity=cap, projection=match_proj, iterations=10,
                         odom_weight=1.0, meas_as_canvas=False)
        first = pipeline.tree_index(meas_stack, 0)
        rest = meas_stack.map(lambda x: x[1:])
        fstate = ft.seed(spec, first, sir, odom=ds.robot_poses[0])
        measF = ft.pack_measurement_batch(rest, odoms[1:])
        nf = measF.shape[0]
        rows.time("fused frame kernel (full step)",
                  lambda: ft.track_sequence_fast(spec, fstate, measF), nf, "frame")
        rows.time("fused frame kernel (grid, no scene)",
                  lambda: track_frames_grid(spec, fstate.cacheT, fstate.pose, measF), nf,
                  "frame")
        spec_c = dataclasses.replace(spec, meas_as_canvas=True, window=128)
        measC = ft.pack_measurement_canvas_batch(spec_c, rest, odoms[1:])
        fstate_c = ft.seed(spec_c, first, sir, odom=ds.robot_poses[0])
        rows.time("fused frame kernel (canvas+win128)",
                  lambda: ft.track_sequence_fast(spec_c, fstate_c, measC), nf, "frame")
        rows.time("fused frame kernel (canvas+win128+pack)",
                  lambda: ft.track_sequence_fast(
                      spec_c, fstate_c, ft.pack_measurement_canvas_batch(spec_c, rest,
                                                                         odoms[1:])),
                  nf, "frame")
        # the in-kernel cost's slopes over Gauss-Newton iterations and merge shift
        for its in (1, 5, 10, 20):
            spec_i = dataclasses.replace(spec, iterations=its)
            rows.time(f"grid kernel, {its:2d} GN iters",
                      lambda: track_frames_grid(spec_i, fstate.cacheT, fstate.pose, measF),
                      nf, "frame")
        for shift in (8, 16, 32, 64):
            spec_s = dataclasses.replace(spec, merge_shift=shift)
            rows.time(f"grid kernel, merge_shift {shift:3d}",
                      lambda: track_frames_grid(spec_s, fstate.cacheT, fstate.pose, measF),
                      nf, "frame")

        def noop_chain():
            sc = scene
            for _ in range(NOOP_CHAIN):
                sc = sc._replace(xy=sc.xy + 1e-9)
            return sc

        rows.time("noop scan floor", noop_chain, NOOP_CHAIN, "frame")

    def merge_chain():
        sc = scene
        for _ in range(CHAIN):
            sc = merge_op.merge_projective(match_proj, sc, meas0, measurement_in_scene=step)
        return sc

    rows.time("xla full merge alone", merge_chain, CHAIN, "call")
    return {"device": card_description(device), "frames": n_frames, "cap": cap,
            "reps": reps, "mode": "card" if on_card else "cpu_plain (not device numbers)",
            "rows": rows.rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--cap", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--json-out", default=None, help="write the rows as JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' rehearses the "
                         "plain rows on the host)")
    args = ap.parse_args(argv)
    out = run(args.frames, args.cap, args.reps, args.device)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
