"""The per-message loop of ``generic_bench_app`` (route D on a card) on the
CPU, through the JAX package and through the port: the same prefix of
``bench/data/corridor.jsonl`` under ``configurations/corridor.json`` (each
package reads the file itself), one ``SlamRunner`` a package, messages fed
one at a time. After every message that makes a frame it records the graph
counters (variables, factors, closures, relocalizations) and the robot's
pose in the world, then compares the two runs frame by frame and prints
one JSON line: the first frame where a counter differs (or null), the
counters at the end, the largest pose difference, and each package's
seconds. ``--range-noise SIGMA`` adds N(0, SIGMA) metres to every range
(numpy, ``--noise-seed``; the same noise in both packages), to see how far
the outcome moves under a perturbation far below the sensor's noise.

    JAX_PLATFORMS=cpu python tests/message_loop_witness.py --frames 1500 --route D

``--route D`` keeps the configuration's ``use_fast_tracker``: the frame
kernel per message, in the JAX package the Pallas kernel in interpret mode,
in the port its plain version. ``--route C`` turns the fast tracker off
(both packages' plain projective-ICP tracker, no kernel). It is the
reference's witness for the per-message loop's graph on the corridor; the
tier-1 test ``tests/test_torch_message_loop.py`` runs a short prefix."""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATA = "bench/data/corridor.jsonl"
CONFIG = "configurations/corridor.json"


def run_package(pkg: str, frames: int, route: str, root: str = ".", range_noise: float = 0.0,
                noise_seed: int = 1) -> dict:
    """``frames`` frames of the corridor through ``pkg``'s ``SlamRunner``:
    per frame (variables, factors, closures, relocalizations) and the
    robot's pose in the world."""
    import importlib

    config = importlib.import_module(f"{pkg}.utils.config")
    importlib.import_module(f"{pkg}.utils.presets")     # registers the config classes
    sources = importlib.import_module(f"{pkg}.io.sources")
    runner_mod = importlib.import_module(f"{pkg}.models.runner")
    mgr = config.ConfigManager.read(os.path.join(root, CONFIG))
    slam_cfg = mgr.get_by_name("slam")
    if route == "C":
        slam_cfg = dataclasses.replace(slam_cfg, use_fast_tracker=False)
    dev = {"device": "cpu"} if pkg.endswith("_torch") else {}
    runner = runner_mod.SlamRunner(slam_config=slam_cfg,
                                   preprocessor_config=mgr.get_by_name("preprocessor"), **dev)
    counters, poses = [], []
    rng = np.random.default_rng(noise_seed)
    t0 = time.perf_counter()
    for msg in sources.JsonlFileSource(os.path.join(root, DATA)):
        if range_noise and len(getattr(msg, "ranges", ())):
            r = np.asarray(msg.ranges, np.float32)
            msg.ranges = r + rng.normal(0.0, range_noise, r.shape).astype(np.float32)
        if not runner.put_message(msg):
            continue
        s = runner.slam
        counters.append((int(s.num_variables()), int(s.num_factors()), int(s.num_closures),
                         int(s.relocalizations)))
        poses.append(np.asarray(s.robot_in_world(), np.float64))
        if len(counters) >= frames:
            break
    return {"counters": counters, "poses": np.stack(poses),
            "seconds": time.perf_counter() - t0}


def compare(jax_run: dict, torch_run: dict) -> dict:
    """The first frame whose counters differ, the end counters, the largest
    pose difference over the frames (angles wrapped)."""
    jc, tc = jax_run["counters"], torch_run["counters"]
    first = next((k for k, (a, b) in enumerate(zip(jc, tc)) if a != b), None)
    n = min(len(jc), len(tc))
    d = np.abs(jax_run["poses"][:n] - torch_run["poses"][:n])
    d[:, 2] = np.abs(np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2])))
    names = ("variables", "factors", "closures", "relocalizations")
    return {"frames": [len(jc), len(tc)], "first_counter_difference": first,
            "end": {"jax": dict(zip(names, jc[-1])), "torch": dict(zip(names, tc[-1]))},
            "max_pose_difference": {"xy_m": float(d[:, :2].max()), "theta_rad": float(d[:, 2].max())},
            "seconds": {"jax": jax_run["seconds"], "torch": torch_run["seconds"]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--route", choices=["D", "C"], default="D")
    ap.add_argument("--range-noise", type=float, default=0.0)
    ap.add_argument("--noise-seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    noise = dict(range_noise=args.range_noise, noise_seed=args.noise_seed)
    result = {"route": args.route, **noise, **compare(
        run_package("srrg2_laser_slam_2d_tpu", args.frames, args.route, **noise),
        run_package("srrg2_laser_slam_2d_tpu_torch", args.frames, args.route, **noise))}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
