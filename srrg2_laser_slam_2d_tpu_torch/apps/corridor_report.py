"""Render the corridor benchmark (counterpart of
``srrg2_laser_slam_2d_tpu/apps/corridor_report.py``): the world's walls, the
ground truth and the estimated trajectory, and the per-frame translation
error, into one PNG of two panels. Host work only.

The JAX package draws with matplotlib; this report draws the same arrays as
``viz/canvas.py`` primitives: the walls as points, each trajectory as a
polyline, and the error curve as a polyline over frame-and-error axes
(frames scaled to [0, ``CURVE_WIDTH``], the error to [0, 1] of its maximum),
with no text.

Usage: python -m srrg2_laser_slam_2d_tpu_torch.apps.corridor_report \\
           --gt gt.tum --est traj.tum -o corridor_report.png
"""

from __future__ import annotations

import argparse

import numpy as np

from ..bench import synthetic
from ..io import tum
from ..viz.canvas import Canvas, write_png

CURVE_WIDTH = 1.6       # the error panel's width over its height (the JAX figure's ratio)
TICKS = 10              # tick marks on each axis of the error panel


def report_arrays(gt_path: str, est_path: str, beams: int = 721):
    """(wall points [W, 2], ground truth [n, 3], estimate in the ground
    truth's frame [n, 3], translation error [n]) over the first n frames
    both files have. The SLAM frame anchors at the first pose, so the
    estimate is moved by the first ground-truth pose."""
    world = synthetic.corridor_world(synthetic.CorridorConfig(num_beams=beams))
    wxy = world.xy.numpy()[world.valid.numpy()]
    _, gt = tum.read_tum(gt_path)
    _, est = tum.read_tum(est_path)
    n = min(len(gt), len(est))
    gt, est = np.asarray(gt)[:n], np.asarray(est)[:n]
    c, s = np.cos(gt[0, 2]), np.sin(gt[0, 2])
    R = np.array([[c, -s], [s, c]], np.float32)
    est_w = est.copy()
    est_w[:, :2] = (R @ est[:, :2].T).T + gt[0, :2]
    est_w[:, 2] = est[:, 2] + gt[0, 2]
    err = np.linalg.norm(est_w[:, :2] - gt[:, :2], axis=1)
    return wxy, gt, est_w, err


def draw(world: Canvas, curve: Canvas, wxy, gt, est_w, err) -> None:
    """The report's draw calls: the map panel on ``world``, the error curve
    on ``curve``."""
    world.set_point_size(0.3)
    world.put_points(wxy, color="#A5ADBB")
    world.put_trajectory(gt, color="#5A7DCF")
    world.put_trajectory(est_w, color="#C46A4B")
    n = len(err)
    frames = CURVE_WIDTH * np.arange(n) / max(n - 1, 1)
    curve.put_segments(np.zeros((2, 2)), [[CURVE_WIDTH, 0.0], [0.0, 1.0]], color="black")
    ticks = np.linspace(0.0, 1.0, TICKS + 1)
    curve.put_segments(np.stack([CURVE_WIDTH * ticks, 0 * ticks], 1),
                       np.stack([CURVE_WIDTH * ticks, 0 * ticks - 0.02], 1), color="black")
    curve.put_segments(np.stack([0 * ticks, ticks], 1), np.stack([0 * ticks - 0.02, ticks], 1),
                       color="black")
    curve.put_trajectory(np.stack([frames, err / max(float(err.max()), 1e-9)], 1),
                         color="#C46A4B")


def render(path: str, wxy, gt, est_w, err) -> str:
    """Both panels side by side in one PNG at ``path``."""
    world = Canvas("corridor benchmark", figsize=(8.6, 6))
    curve = Canvas("per-frame error vs ground truth", figsize=(5.4, 6))
    draw(world, curve, wxy, gt, est_w, err)
    write_png(path, np.concatenate([world.render(), curve.render()], axis=1))
    return path


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--est", required=True)
    ap.add_argument("-o", "--output", default="corridor_report.png")
    ap.add_argument("--beams", type=int, default=721)
    args = ap.parse_args(argv)
    wxy, gt, est_w, err = report_arrays(args.gt, args.est, args.beams)
    render(args.output, wxy, gt, est_w, err)
    print(f"wrote {args.output}  ({len(err)} frames, final err {err[-1]:.2f} m, "
          f"max {err.max():.2f} m, rmse {np.sqrt(np.mean(err ** 2)):.3f} m)")
    return args.output


if __name__ == "__main__":
    main()
