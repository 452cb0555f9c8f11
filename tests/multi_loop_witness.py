"""The MULTI loop of chip_smoke.py on the CPU, through the JAX package and
through the port's plain route: the same dual-laser circle drive (400 steps
of 0.15 m and 2 pi / 40, seed 5, a front and a rear laser of 721 beams,
odometry noise 0.02, the front laser blanked over steps 100-159), once
through ``SlamRunner(scan_topics=...)`` under ``multi_slam(721, 8192)`` and
once through the front laser alone under ``laser0_slam(721, 8192)``. It
prints one JSON line per run (ATE against ground truth, graph counters)
and, with ``--out``, writes them to a file. ``--fov`` is each laser's field
of view in degrees: 180 as in chip_smoke.py, or 144, the synthetic world's
default, on which both packages lose the heading.

    JAX_PLATFORMS=cpu python tests/multi_loop_witness.py --fov 180 --out w.json

It is the reference's witness for the chip run's MULTI loop: the JAX
package on this drive is what the port's ATE is held against."""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BEAMS = 721
EXTRINSICS = ((0.2, 0.0, 0.0), (-0.2, 0.0, float(np.pi)))
FRAMES = ("laser_frame_0", "laser_frame_1")
DRIVE = dict(num_beams=BEAMS, max_variance=0.02, drift=(0.15, 0.0, 2 * np.pi / 40), seed=5)
STEPS = 400
OCCLUDED = (0, 100, 160)


def _run_package(pkg, fov, kernel_route, device=None):
    """Both runs of one package; ``pkg`` is the JAX package or the port."""
    import importlib

    gen = importlib.import_module(f"{pkg}.apps.synthetic_scene_generator")
    synthetic = importlib.import_module(f"{pkg}.bench.synthetic")
    suite = importlib.import_module(f"{pkg}.bench.suite")
    sources = importlib.import_module(f"{pkg}.io.sources")
    pre = importlib.import_module(f"{pkg}.models.preprocessor")
    runner_mod = importlib.import_module(f"{pkg}.models.runner")
    presets = importlib.import_module(f"{pkg}.utils.presets")
    dev = {} if device is None else dict(device=device)

    half = np.pi * (fov / 360)      # 144 gives the world's default, pi * 0.4
    dss = [synthetic.simulate(synthetic.SyntheticConfig(sensor_in_robot=e, steps=STEPS,
                                                        angle_min=-half, angle_max=half, **DRIVE),
                              **dev) for e in EXTRINSICS]
    msgs = gen.dual_dataset_to_messages(*dss, frames=FRAMES, odom_noise=0.02,
                                        occlude=OCCLUDED, seed=5)
    gt_t = [m.timestamp for m in msgs if getattr(m, "topic", "") == "/scan_0"]
    pcfg = pre.PreprocessorConfig(voxelize_resolution=0.02, normal_window=8)
    out = {}
    for name, kw, cfg in (
            ("dual", dict(scan_topics=["/scan_0", "/scan_1"], sensor_frames=list(FRAMES)),
             presets.multi_slam(BEAMS, 8192, use_fused_aligner=kernel_route, **dev)),
            ("single", dict(scan_topic="/scan_0", sensor_frame=FRAMES[0]),
             presets.laser0_slam(BEAMS, 8192, use_fast_tracker=kernel_route, **dev))):
        runner = runner_mod.SlamRunner(slam_config=cfg, preprocessor_config=pcfg,
                                       base_frame="base_frame", **dev, **kw)
        topics = ["/tf", "/odom"] + kw.get("scan_topics", [kw.get("scan_topic")])
        t0 = time.perf_counter()
        n = runner.run(sources.SynchronizedSource(sources.ListSource(msgs), topics,
                                                  time_interval=0.1))
        wall = time.perf_counter() - t0
        s = suite.BenchmarkSuite()
        s.set_ground_truth(np.asarray(gt_t, np.float64), dss[0].robot_poses)
        for t, p, d in runner.trajectory:
            s.set_pose_estimate(p, t, d)
        slam = runner.slam
        out[name] = {"package": pkg, "kernel_route": kernel_route, "fov_deg": fov, "frames": n,
                     "wall_s": wall,
                     "ate_rmse_translation_m": float(s.compute()["rmse_translation"]),
                     "graph_variables": int(slam.num_variables()),
                     "graph_factors": int(slam.num_factors()),
                     "closures": int(slam.num_closures),
                     "relocalizations": int(slam.relocalizations)}
        print(json.dumps(out[name]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fov", type=float, default=180.0)
    ap.add_argument("--route", choices=["kernel", "plain"], default="kernel")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    kernel_route = args.route == "kernel"
    result = {"jax": _run_package("srrg2_laser_slam_2d_tpu", args.fov, kernel_route),
              "torch": _run_package("srrg2_laser_slam_2d_tpu_torch", args.fov, kernel_route,
                                    device="cpu")}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
