"""Stage-wise visual validation: offline equivalents of the reference's
interactive ``visual_test_*`` apps (counterpart of
``srrg2_laser_slam_2d_tpu/apps/visual_tests.py``). Each stage renders its
inputs and outputs to a PNG through ``viz/canvas.py`` (the same draw calls
as the JAX package's stages; the canvas needs numpy alone).

Usage: python -m srrg2_laser_slam_2d_tpu_torch.apps.visual_tests \\
           --stage {adaptor,correspondences,clipper,merger,aligner,tracker,all} \\
           [--outdir out/] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .._device import resolve_device
from ..bench import synthetic
from ..models import tracker as tracker_mod
from ..models.preprocessor import LaserModel, PreprocessorConfig, ScanPreprocessor
from ..ops import clip as clip_op
from ..ops import icp
from ..ops import merge as merge_op
from ..ops import projector as projector_op
from ..ops.projector import PolarProjection
from ..utils import cloud as cloud_op
from ..utils import geometry
from ..viz.canvas import Canvas


def _setup(device=None):
    device = resolve_device(device)
    ds = synthetic.simulate(synthetic.SyntheticConfig(steps=6, num_beams=512), device)
    cfg = ds.config
    pre = ScanPreprocessor(PreprocessorConfig(voxelize_resolution=0.02, normal_window=8),
                           device=device)
    pre.set_model(LaserModel(num_beams=cfg.num_beams, angle_min=cfg.angle_min,
                             angle_max=cfg.angle_max, range_min=cfg.range_min,
                             range_max=cfg.range_max))
    proj = PolarProjection.make(cols=512, angle_min=-np.pi, angle_max=np.pi,
                                range_min=0.1, range_max=30.0)
    return ds, pre, proj


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _pose(pre: ScanPreprocessor, x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=pre.device)


def stage_adaptor(outdir, ds, pre, proj):
    """visual_test_measurement_adaptor_projective_2d: adaptor output and normals."""
    cloud = pre.compute(ds.ranges[0])
    c = Canvas("adaptor")
    c.put_cloud(cloud, color="#1f77b4")
    valid = _host(cloud.valid)
    xy, nm = _host(cloud.xy)[valid], _host(cloud.normal)[valid]
    c.put_segments(xy, xy + 0.1 * nm, color="#2ca02c")
    c.put_reference_system()
    return c.flush(os.path.join(outdir, "visual_test_adaptor.png"))


def stage_correspondences(outdir, ds, pre, proj):
    """visual_test_correspondence_finder_projective_2d."""
    fixed = pre.compute(ds.ranges[0])
    moving = pre.compute(ds.ranges[1])
    canvas_fixed = projector_op.project_local(proj, fixed)
    corr = icp.find_projective(proj, canvas_fixed, fixed, moving,
                               torch.zeros(3, device=pre.device), 0.5, 0.8)
    c = Canvas("correspondences")
    c.put_cloud(fixed, color="#1f77b4")
    c.put_cloud(moving, color="#2ca02c")
    v = _host(corr.valid)
    fi, mi = _host(corr.fixed_idx)[v], _host(corr.moving_idx)[v]
    c.put_segments(_host(fixed.xy)[fi], _host(moving.xy)[mi], color="magenta")
    return c.flush(os.path.join(outdir, "visual_test_correspondences.png"))


def stage_clipper(outdir, ds, pre, proj):
    """visual_test_scene_clipper_projective_2d."""
    scene = cloud_op.repad(ds.scene, 4096)
    robot = _pose(pre, ds.robot_poses[3])
    sensor = _pose(pre, ds.config.sensor_in_robot)
    clipped = clip_op.clip_projective(proj, scene, robot, sensor)
    c = Canvas("clipper")
    c.put_cloud(scene, color="#cccccc")
    c.push_matrix()
    c.mult_matrix(_host(robot))
    c.put_cloud(clipped, color="#d62728")
    c.put_reference_system(0.5)
    c.pop_matrix()
    return c.flush(os.path.join(outdir, "visual_test_clipper.png"))


def stage_merger(outdir, ds, pre, proj):
    """visual_test_merger_projective_2d."""
    scene = cloud_op.repad(pre.compute(ds.ranges[0]), 4096)
    meas = pre.compute(ds.ranges[1])
    rel = geometry.relative(_pose(pre, ds.sensor_poses[0]), _pose(pre, ds.sensor_poses[1]))
    merged = merge_op.merge_projective(proj, scene, meas, rel)
    c = Canvas("merger")
    c.put_cloud(merged, color="#1f77b4")
    c.put_reference_system()
    return c.flush(os.path.join(outdir, "visual_test_merger.png"))


def stage_aligner(outdir, ds, pre, proj):
    """visual_test_aligner_2d: estimate against the ground truth, and the
    iteration stats."""
    fixed = pre.compute(ds.ranges[0])
    moving = pre.compute(ds.ranges[1])
    res = icp.align(icp.AlignerConfig(max_iterations=10), proj, fixed, moving,
                    torch.zeros(3, device=pre.device))
    t_gt = geometry.relative(_pose(pre, ds.sensor_poses[0]), _pose(pre, ds.sensor_poses[1]))
    print("estimate:", _host(res.estimate))
    print("gt      :", _host(t_gt))
    print("iteration stats (chi, n_corr, n_inl, chi_inl):")
    print(_host(res.stats))
    c = Canvas("aligner")
    c.put_cloud(fixed, color="#1f77b4")
    c.put_cloud(cloud_op.transform(moving, res.estimate), color="#2ca02c")
    c.put_reference_system()
    return c.flush(os.path.join(outdir, "visual_test_aligner.png"))


def stage_tracker(outdir, ds, pre, proj):
    """visual_test_tracker_2d: the scene after the sequence, the tracked and
    the true trajectory."""
    tcfg = tracker_mod.TrackerConfig(scene_capacity=4096, projection=proj,
                                     aligner=icp.AlignerConfig(max_iterations=10))
    trk = tracker_mod.LaserTracker(tcfg, sensor_in_robot=np.array(ds.config.sensor_in_robot),
                                   device=pre.device)
    poses = []
    for k in range(len(ds.ranges)):
        trk.compute(pre.compute(ds.ranges[k]), None)
        poses.append(_host(trk.robot_in_local_map))
    c = Canvas("tracker")
    c.put_cloud(trk.state.scene, color="#1f77b4")
    c.put_trajectory(np.stack(poses), color="red")
    c.put_trajectory(ds.robot_poses, color="green")
    return c.flush(os.path.join(outdir, "visual_test_tracker.png"))


STAGES = {
    "adaptor": stage_adaptor,
    "correspondences": stage_correspondences,
    "clipper": stage_clipper,
    "merger": stage_merger,
    "aligner": stage_aligner,
    "tracker": stage_tracker,
}


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--stage", default="all", choices=list(STAGES) + ["all"])
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the host)")
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    setup = _setup(args.device)
    names = list(STAGES) if args.stage == "all" else [args.stage]
    outs = []
    for name in names:
        outs.append(STAGES[name](args.outdir, *setup))
        print(f"{name}: {outs[-1]}")
    return outs


if __name__ == "__main__":
    main()
