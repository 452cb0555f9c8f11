"""Headless dataset benchmark runner: per-message timing, TUM trajectory
dump, timing file, mean frame time, and the ATE / regression gate of the
benchmark suite. Counterpart of
``srrg2_laser_slam_2d_tpu/apps/generic_bench_app.py``.

Usage (the CUDA card by default; without one it raises):
  python -m srrg2_laser_slam_2d_tpu_torch.apps.generic_bench_app \
      -i log.jsonl | --carmen log.clf [-c config.json] [--gt gt.tum] \
      [-o traj.tum] [-t timings.txt] [--gate killian|simul|corridor] \
      [--json-out art.json] [--max-frames N] [--chunked N] \
      [--checkpoint ckpt.npz [--checkpoint-every N]] [--device cuda|cpu]

The per-message loop (``--chunked 0``, the default) reads the pose back
once per frame; ``--chunked N`` runs the chunk-batched loop instead. The
tracker route of the per-message loop is the configuration's
(``use_fast_tracker`` and the ``TrackerConfig`` flags). A CARMEN log
carries its own ground truth (the laser poses; the app then tracks the
laser, with a zero extrinsic). ``--checkpoint`` saves the per-message
loop every ``--checkpoint-every`` frames and at the end; if the file is
there, the run resumes from it, skipping the frames it holds.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def _commit() -> str | None:
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def run(args, messages: list | None = None):
    """Run the app for parsed arguments (``messages``: a log already read).
    Returns (exit code, artifact dict, runner)."""
    import torch

    from .._device import card_description, resolve_device
    from ..bench import suite as suite_mod
    from ..io import carmen as carmen_io
    from ..io import sources, tum
    from ..models.runner import SlamRunner
    from ..utils import checkpoint as ckpt
    from ..utils import config as config_mod
    from ..utils import presets

    if not args.input and not args.carmen and messages is None:
        print("ERROR: provide -i or --carmen", file=sys.stderr)
        return -1, {}, None
    if args.checkpoint and args.chunked:
        print("ERROR: --checkpoint requires the per-message loop", file=sys.stderr)
        return -1, {}, None
    device = resolve_device(args.device)
    slam_cfg = pre_cfg = None
    if args.config:
        mgr = config_mod.ConfigManager.read(args.config)
        slam_cfg, pre_cfg = mgr.get_by_name("slam"), mgr.get_by_name("preprocessor")
    slam_cfg = slam_cfg or presets.laser0_slam(device=device)
    pre_cfg = pre_cfg or presets.laser0_preprocessor()
    if args.chunked:
        from ..models.chunked_slam import ChunkedSlamRunner

        runner = ChunkedSlamRunner(slam_config=slam_cfg, preprocessor_config=pre_cfg,
                                   chunk=args.chunked, device=device)
    else:
        runner = SlamRunner(slam_config=slam_cfg, preprocessor_config=pre_cfg, device=device)
    if args.checkpoint and ckpt.exists(args.checkpoint):
        resume_n = len(ckpt.trajectory_from(args.checkpoint))
        runner.skip_frames = resume_n
        runner.resume_checkpoint = args.checkpoint
        print(f"resuming from {args.checkpoint} at frame {resume_n}")
    gt = None
    if messages is not None:
        source = sources.ListSource(messages)
    elif args.carmen:
        packs, gt_arr = carmen_io.load_packs(args.carmen, args.max_frames)
        source = sources.ListSource(packs)
        runner.sensor_in_robot = np.zeros(3, np.float32)
        gt = (gt_arr[:, 0], gt_arr[:, 1:])
    else:
        source = sources.JsonlFileSource(args.input)
    if args.gt:
        gt = tum.read_tum(args.gt)

    t_start = time.perf_counter()
    if args.checkpoint:
        n = 0
        for msg in source:
            if runner.put_message(msg):
                n += 1
                if n % args.checkpoint_every == 0:
                    ckpt.save(args.checkpoint, runner.slam, runner.trajectory)
                if args.max_frames is not None and n >= args.max_frames:
                    break
        if runner.slam is not None:
            ckpt.save(args.checkpoint, runner.slam, runner.trajectory)
    else:
        n = runner.run(source, args.max_frames)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    total_dataset_time = time.perf_counter() - t_start
    summary = runner.timing_summary()
    print(f"total_dataset_time [ {total_dataset_time:.3f} ] s")
    print(f"total_compute_time [ {summary.get('total_compute_time', 0):.3f} ] s")
    print(f"mean_frame_time [ {summary.get('mean_frame_time', 0):.4f} ] s -- "
          f"mean_fps [ {summary.get('mean_frame_hz', 0):.1f} ] Hz")

    if args.output:
        tum.write_tum(args.output, [t for t, _, _ in runner.trajectory],
                      [p for _, p, _ in runner.trajectory])
    if args.timing:
        with open(args.timing, "w") as f:
            f.write(f"total_frames= {n} "
                    f"total_compute_time= {summary.get('total_compute_time', 0):.4f} "
                    f"mean_frame_time= {summary.get('mean_frame_time', 0):.6f} "
                    f"mean_frame_hz= {summary.get('mean_frame_hz', 0):.2f}\n")

    slam = runner.slam
    artifact = {
        "input": args.input or args.carmen,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device)),
        "card": card_description(device),
        "config": args.config,
        "commit": _commit(),
        "mode": f"chunked[{args.chunked}]" if args.chunked else "per_message",
        "frames": n,
        "total_dataset_time_s": total_dataset_time,
        "total_compute_time_s": summary.get("total_compute_time", 0),
        "mean_frame_time_s": summary.get("mean_frame_time", 0),
        "mean_frame_hz": summary.get("mean_frame_hz", 0),
        "preprocess_time_s": summary.get("preprocess_time"),
        "phases": summary.get("phases", {}),
        "graph_variables": slam.num_variables() if slam else 0,
        "graph_factors": slam.num_factors() if slam else 0,
        "closures": slam.num_closures if slam else 0,
        "relocalizations": slam.relocalizations if slam else 0,
    }
    rc = 0
    if gt is not None:
        bench = suite_mod.BenchmarkSuite()
        bench.set_ground_truth(*gt)
        for t, p, d in runner.trajectory:
            bench.set_pose_estimate(p, t, d)
        stats = bench.compute()
        print(f"ATE rmse_translation [ {stats['rmse_translation']:.4f} ] m | "
              f"mean_rotation [ {stats['mean_rotation']:.4f} ] rad")
        artifact["ate"] = {k: (np.asarray(v).tolist() if np.ndim(v) else float(v))
                           for k, v in stats.items()}
        if args.gate != "none":
            thr = {"killian": suite_mod.KILLIAN_THRESHOLDS,
                   "simul": suite_mod.SIMUL_THRESHOLDS,
                   "corridor": suite_mod.CORRIDOR_THRESHOLDS}[args.gate]
            regression = bench.is_regression(thr, stats)
            artifact["gate"] = args.gate
            artifact["gate_verdict"] = "REGRESSION" if regression else "PASS"
            if regression:
                print("REGRESSION detected")
                rc = -1
            else:
                print("benchmark complete! (no regression)")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(artifact, f, indent=1)
    return rc, artifact, runner


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-i", "--input", default=None, help="JSONL message log")
    ap.add_argument("--carmen", default=None,
                    help="CARMEN log (its laser poses are the ground truth)")
    ap.add_argument("-c", "--config", default=None, help="named-assembly config file")
    ap.add_argument("--gt", default=None, help="ground-truth TUM file")
    ap.add_argument("-o", "--output", default=None, help="TUM trajectory output")
    ap.add_argument("-t", "--timing", default=None, help="timing output file")
    ap.add_argument("--gate", choices=["killian", "simul", "corridor", "none"], default="none")
    ap.add_argument("--json-out", default=None,
                    help="write a JSON artifact (ATE, gate verdict, timing, card, commit)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--chunked", type=int, default=0, metavar="N",
                    help="chunk-batched loop with N frames per launch; 0 = per-message loop")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint path: saved every --checkpoint-every frames and at the "
                         "end; if the file exists, the run RESUMES from it")
    ap.add_argument("--checkpoint-every", type=int, default=400)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions)")
    return ap


def main(argv=None) -> int:
    rc, _, _ = run(parser().parse_args(argv))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
