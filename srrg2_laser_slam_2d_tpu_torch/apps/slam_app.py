"""The reference's main SLAM app: a configuration-built pipeline over a
message log or a CARMEN log, the trajectory and the map as output (a PNG
in place of the live viewer), and default-configuration generation (-j).
Counterpart of ``srrg2_laser_slam_2d_tpu/apps/slam_app.py``.

Usage (the CUDA card by default; without one it raises):
  python -m srrg2_laser_slam_2d_tpu_torch.apps.slam_app -c slam.json -i log.jsonl \
      [-o traj.tum] [--draw map.png] [--carmen log.clf] [--max-frames N] \
      [--chunked N] [--boss-config assembly.json] [--device cuda|cpu]
  python -m srrg2_laser_slam_2d_tpu_torch.apps.slam_app -j -c slam.json   # write a config

Without ``-c`` (or with a file that is not there) it runs the LASER_0
preset, which on a card tracks through the frame kernel, one launch per
message. ``--chunked N`` runs the chunk-batched loop instead (one frame
kernel launch per N frames; closure candidates through the NN-ICP kernel
on the ``fused_nn`` detector backend). ``--boss-config`` reads a
reference-format BOSS assembly instead (``io/boss_config.py``): LASER_0
tracks with plain projective ICP per message (the frame kernel under
``--chunked``); a MULTI assembly aligns through the multi-cue aligner kernel
on a card. Like the JAX app, it feeds one laser topic: a MULTI assembly needs
``SlamRunner(scan_topics=...)``, and ``--chunked`` refuses it.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_runner(args, device):
    """The runner the arguments ask for, on ``device``."""
    from ..models.chunked_slam import ChunkedSlamRunner
    from ..models.runner import SlamRunner
    from ..utils import config as config_mod
    from ..utils import presets

    slam_cfg = pre_cfg = None
    if args.boss_config:
        # the reference's BOSS assembly, translated (io/boss_config.py)
        from ..io import boss_config

        g = boss_config.load(args.boss_config)
        slam_cfg = boss_config.to_slam_config(g, device=device)
        pre_cfg = boss_config.to_preprocessor_config(g)
    elif args.config and not args.generate_config:
        try:
            mgr = config_mod.ConfigManager.read(args.config)
            slam_cfg, pre_cfg = mgr.get_by_name("slam"), mgr.get_by_name("preprocessor")
        except FileNotFoundError:
            print(f"config {args.config} not found, using LASER_0 preset", file=sys.stderr)
    slam_cfg = slam_cfg or presets.laser0_slam(device=device)
    pre_cfg = pre_cfg or presets.laser0_preprocessor()
    if args.chunked:
        return ChunkedSlamRunner(slam_config=slam_cfg, preprocessor_config=pre_cfg,
                                 chunk=args.chunked, scan_topic=args.scan_topic,
                                 odom_topic=args.odom_topic, device=device)
    return SlamRunner(slam_config=slam_cfg, preprocessor_config=pre_cfg,
                      scan_topic=args.scan_topic, odom_topic=args.odom_topic,
                      sensor_frame=args.sensor_frame, base_frame=args.base_frame,
                      device=device)


def run(args):
    """Run the app for parsed arguments. Returns (exit code, runner or None)."""
    from .._device import resolve_device
    from ..io import carmen as carmen_io
    from ..io import sources, tum
    from ..utils import presets

    device = resolve_device(args.device)
    if args.generate_config:
        presets.default_config_manager(device=device).write(args.config)
        print(f"configuration written in: {args.config}")
        return 0, None
    runner = build_runner(args, device)
    if args.carmen:
        packs, _ = carmen_io.load_packs(args.carmen, args.max_frames)
        source = sources.ListSource(packs)
        runner.sensor_in_robot = np.zeros(3, np.float32)
    elif args.input:
        source = sources.JsonlFileSource(args.input)
    else:
        print("ERROR: provide -i log.jsonl or --carmen log.clf", file=sys.stderr)
        return -1, None

    n = runner.run(source, args.max_frames)
    summary = runner.timing_summary()
    slam = runner.slam
    print(f"processed {n} frames | local maps {slam.num_variables()} | "
          f"factors {slam.num_factors()} | closures {slam.num_closures} | "
          f"mean_frame_hz {summary.get('mean_frame_hz', 0):.1f}")
    if args.output:
        tum.write_tum(args.output, [t for t, _, _ in runner.trajectory],
                      [p for _, p, _ in runner.trajectory])
        print(f"trajectory written to {args.output}")
    if args.draw:
        from ..viz.canvas import Canvas

        canvas = Canvas("slam_map")
        runner.draw(canvas)
        print(f"map rendered to {canvas.flush(args.draw)}")
    return 0, runner


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-c", "--config", default="laser_slam2d.json",
                    help="config file to read (or, with -j, to write)")
    ap.add_argument("-j", "--generate-config", action="store_true",
                    help="generate a default configuration and exit")
    ap.add_argument("--boss-config", default=None,
                    help="read a reference-format BOSS pipeline config")
    ap.add_argument("-i", "--input", default=None, help="input JSONL message log")
    ap.add_argument("--carmen", default=None, help="input CARMEN log")
    ap.add_argument("-o", "--output", default=None, help="TUM trajectory output")
    ap.add_argument("--draw", default=None, help="render the map to PNG")
    ap.add_argument("--scan-topic", default=None)
    ap.add_argument("--odom-topic", default="/odom")
    ap.add_argument("--sensor-frame", default="scan")
    ap.add_argument("--base-frame", default="base_frame")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--chunked", type=int, default=0, metavar="N",
                    help="chunk-batched loop with N frames per launch; 0 = per-message loop")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions)")
    return ap


def main(argv=None) -> int:
    rc, _ = run(parser().parse_args(argv))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
