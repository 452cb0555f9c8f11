"""Corridor acceptance benchmark of the port: the end-to-end run.

Runs the 2,871-frame corridor log (``bench/data/corridor.jsonl``) through
the chunk-batched SLAM loop (``models/chunked_slam.py``) twice in one
process, cold (kernel builds and first-use set-up included) and warm, then
once more under the lean configuration (no validator, closure merger or
relocalizer). The gate passes only if the ATE of the warm pass stays
inside ``CORRIDOR_THRESHOLDS`` and loop closures were accepted
(graph factors > graph variables - 1); the exit code is 0 only then.

The artifact records the device name and the commit.

``--spread`` measures instead how far the outcome moves under input
perturbations far below the sensor noise. The loop is chaotic at its
thresholds (a local-map split fires when |X| crosses
``local_map_distance``, a closure candidate is selected when two map
origins lie within a gate), so implementations that round differently
produce different trajectories from the same log. ``spread`` reruns the
gated configuration ``SPREAD_RUNS`` times, the first on the log as it is
and each other with N(0, ``SPREAD_SIGMA``) metres added to every range, and
reports ATE, closures and graph size per run.

Usage (the CUDA card by default; without one it raises):
  python -m srrg2_laser_slam_2d_tpu_torch.bench.corridor_e2e \
      [--chunk 1024] [--config configurations/corridor.json] \
      [--lean-config configurations/corridor_lean.json] [--out art.json] \
      [--tum traj.tum] [--max-frames N] [--single-pass] [--spread] [--device cuda]
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

DATA = "bench/data/corridor.jsonl"
GROUND_TRUTH = "bench/data/corridor_gt.tum"
SPREAD_RUNS = 8
SPREAD_SIGMA = 1e-5


def load_messages(path: str = DATA) -> list:
    from ..io.sources import JsonlFileSource

    return list(JsonlFileSource(path))


def first_frames(messages: list, n: int, pcfg, device):
    """The first ``n`` laser frames of a log as preprocessed clouds on
    ``device``, with the odometry each frame saw ([n, 3] numpy)."""
    import numpy as np

    from ..io.messages import LaserMessage, OdometryMessage
    from ..models.preprocessor import LaserModel, ScanPreprocessor

    ranges, odoms, last, model = [], [], np.zeros(3, np.float32), None
    for m in messages:
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


def run_pass(cfg_path: str, chunk: int, max_frames: int | None, device=None,
             messages: list | None = None):
    """One pass over the corridor log under a configuration file. Returns
    (summary dict, runner)."""
    from ..utils import config as config_mod

    mgr = config_mod.ConfigManager.read(cfg_path)
    return run_configs(mgr.get_by_name("slam"), mgr.get_by_name("preprocessor"), chunk,
                       max_frames, device, messages)


def run_configs(slam_cfg, pre_cfg, chunk: int, max_frames: int | None, device=None,
                messages: list | None = None):
    """One pass over the corridor log under the given SLAM and
    preprocessor configurations. Returns (summary dict, runner)."""
    from ..io import tum
    from ..io.sources import ListSource
    from ..models.chunked_slam import ChunkedSlamRunner
    from . import suite as suite_mod

    runner = ChunkedSlamRunner(slam_config=slam_cfg, preprocessor_config=pre_cfg,
                               chunk=chunk, device=device)
    msgs = load_messages() if messages is None else messages
    t0 = time.perf_counter()
    n = runner.run(ListSource(msgs), max_frames)
    wall = time.perf_counter() - t0

    bench = suite_mod.BenchmarkSuite()
    bench.set_ground_truth(*tum.read_tum(GROUND_TRUTH))
    for t, p, d in runner.trajectory:
        bench.set_pose_estimate(p, t, d)
    stats = bench.compute()
    regression = bench.is_regression(suite_mod.CORRIDOR_THRESHOLDS, stats)
    summary = runner.timing_summary()
    slam = runner.slam
    return {
        "frames": n,
        "wall_s": wall,
        "compute_s": summary["total_compute_time"],
        "mean_frame_hz": summary["mean_frame_hz"],
        "chunks": summary["chunks"],
        "phases": summary.get("phases", {}),
        "graph_variables": slam.num_variables(),
        "graph_factors": slam.num_factors(),
        "closures": slam.num_closures,
        "relocalizations": slam.relocalizations,
        "ate_rmse_translation_m": float(stats["rmse_translation"]),
        "ate_mean_rotation_rad": float(stats["mean_rotation"]),
        "gate_verdict": "REGRESSION" if regression else "PASS",
    }, runner


def perturbed(messages: list, sigma: float, seed: int) -> list:
    """A copy of the log with N(0, sigma) added to every laser range."""
    import numpy as np

    from ..io.messages import LaserMessage

    rng = np.random.default_rng(seed)
    out = []
    for m in messages:
        if isinstance(m, LaserMessage):
            m = copy.copy(m)
            r = np.asarray(m.ranges, np.float32)
            m.ranges = (r + rng.normal(0.0, sigma, r.shape)).astype(np.float32)
        out.append(m)
    return out


def spread(cfg_path: str, chunk: int, device, messages: list) -> list[dict]:
    """One row per run: the unperturbed log, then SPREAD_RUNS - 1 runs with
    range noise of SPREAD_SIGMA metres (seeds 1, 2, ...)."""
    rows = []
    for seed in range(SPREAD_RUNS):
        sigma = 0.0 if seed == 0 else SPREAD_SIGMA
        msgs = messages if seed == 0 else perturbed(messages, sigma, seed)
        summary, _ = run_pass(cfg_path, chunk, None, device, msgs)
        rows.append({"seed": seed, "sigma": sigma,
                     **{k: summary[k] for k in ("ate_rmse_translation_m", "closures",
                                                "graph_variables", "graph_factors",
                                                "relocalizations", "gate_verdict")}})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def closures_accepted(summary: dict) -> bool:
    return summary["graph_factors"] > summary["graph_variables"] - 1


def _commit() -> str | None:
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--config", default="configurations/corridor.json")
    ap.add_argument("--lean-config", default="configurations/corridor_lean.json",
                    help="parity row without validator / merger / relocalizer "
                         "('' disables)")
    ap.add_argument("--out", default=None, help="artifact JSON path")
    ap.add_argument("--tum", default=None, help="trajectory of the gated pass")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--single-pass", action="store_true", help="cold pass only")
    ap.add_argument("--spread", action="store_true",
                    help="run the ATE spread under range noise instead of the gate")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args()

    import torch

    from .._device import resolve_device

    device = resolve_device(args.device)
    artifact = {
        "input": DATA,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device)),
        "config": args.config,
        "commit": _commit(),
        "mode": f"chunked[{args.chunk}]",
        "gate": "corridor",
    }
    msgs = load_messages()
    if args.spread:
        artifact["spread"] = spread(args.config, args.chunk, device, msgs)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(artifact, f, indent=1)
        return 0
    cold, runner = run_pass(args.config, args.chunk, args.max_frames, device, msgs)
    artifact["cold"] = cold
    print("cold:", json.dumps(cold), flush=True)
    head = cold
    if not args.single_pass:
        head, runner = run_pass(args.config, args.chunk, args.max_frames, device, msgs)
        artifact["warm"] = head
        print("warm:", json.dumps(head), flush=True)
    if args.lean_config:
        lean, _ = run_pass(args.lean_config, args.chunk, args.max_frames, device, msgs)
        artifact["lean"] = lean
        print("lean:", json.dumps(lean), flush=True)
    closed = closures_accepted(head)
    artifact["loop_closures_accepted"] = closed
    ok = head["gate_verdict"] == "PASS" and closed
    artifact["verdict"] = "PASS" if ok else "FAIL"
    if args.tum:
        from ..io import tum as tum_mod

        tum_mod.write_tum(args.tum, [t for t, _, _ in runner.trajectory],
                          [p for _, p, _ in runner.trajectory])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
    print(json.dumps(artifact))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
