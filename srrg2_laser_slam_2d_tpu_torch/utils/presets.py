"""Shipped pipeline presets: the LASER_0 assembly (one laser and wheel
odometry) and the MULTI assembly (two lasers and wheel odometry).
Counterpart of the presets of ``srrg2_laser_slam_2d_tpu/utils/presets.py``,
with its default assembly for ``slam_app -j``; the configuration classes
register themselves in ``utils/config.py``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models import loop_closure as lc
from ..models import slam as slam_mod
from ..models import tracker as tracker_mod
from ..models.preprocessor import PreprocessorConfig
from ..ops import icp
from ..ops.projector import PolarProjection
from ..solver import pgo
from . import config as config_mod


def reference_projection(num_beams: int = 721) -> PolarProjection:
    """The matching / merging / clipping canvas of the shipped
    configurations: 721 beams over +-pi, ranges [0.3, 20] m."""
    return PolarProjection.make(cols=num_beams, angle_min=-math.pi, angle_max=math.pi,
                                range_min=0.3, range_max=20.0)


def laser0_tracking_aligner() -> icp.AlignerConfig:
    """Tracking aligner of LASER_0: 10 iterations, point distance 0.5,
    normal cos 0.9, Cauchy 0.01, odometry prior weight 1."""
    return icp.AlignerConfig(max_iterations=10, min_num_inliers=10, point_distance=0.5,
                             normal_cos=0.9, chi_threshold=0.01, odom_weight=1.0)


def laser0_preprocessor() -> PreprocessorConfig:
    return PreprocessorConfig(range_min=0.0, range_max=1000.0, voxelize_resolution=0.02,
                              normal_point_distance=0.3, normal_min_points=5)


def _on_card(device) -> bool:
    """Whether a run on ``device`` (None: the default device) is on a CUDA
    card."""
    return torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"


def laser0_slam(num_beams: int = 721, scene_capacity: int = 8192,
                use_fast_tracker: bool | None = None,
                device=None) -> slam_mod.GraphSLAMConfig:
    """The full LASER_0 SLAM assembly. ``use_fast_tracker`` defaults to ON
    when the run is on a CUDA card (the tracking path is then the fused
    frame kernel) and to OFF on the CPU, where the plain projective ICP
    tracker is the parity oracle."""
    if use_fast_tracker is None:
        use_fast_tracker = _on_card(device)
    return slam_mod.GraphSLAMConfig(
        use_fast_tracker=use_fast_tracker,
        local_map_distance=1.0,
        tracker=tracker_mod.TrackerConfig(
            scene_capacity=scene_capacity, merge_threshold=0.2,
            clip_voxelize_resolution=0.0, projection=reference_projection(num_beams),
            aligner=laser0_tracking_aligner()),
        detector=lc.LoopDetectorConfig(
            relocalize_min_inliers=300, relocalize_min_inliers_ratio=0.8,
            relocalize_max_chi_inliers=0.1,
            aligner=icp.AlignerConfig(max_iterations=30, point_distance=1.414,
                                      normal_cos=0.8, chi_threshold=0.05, odom_weight=0.0)),
        validator=lc.ValidatorConfig(),
        relocalizer=lc.RelocalizerConfig(),
        # Cauchy on the pose-pose edges of the global solve: a wrong closure
        # that survived is down-weighted instead of bending the graph
        global_solver=pgo.PGOConfig(max_iterations=20, epsilon=1e-5, chi_threshold=1.0),
    )


def multi_slam(num_beams: int = 721, scene_capacity: int = 8192,
               cue_extrinsics=((0.0, 0.0, 0.0), (0.0, 0.0, math.pi)),
               use_fused_aligner: bool | None = None,
               device=None) -> slam_mod.GraphSLAMConfig:
    """The MULTI assembly: LASER_0 with a second laser, i.e. the tracker
    runs as ``MultiCueTracker`` over ``cue_extrinsics`` (the sensor-in-robot
    poses of the lasers; default front at the base frame, rear turned by
    pi). ``use_fused_aligner`` defaults to ON on a CUDA card (the multi-cue
    aligner kernel) and to OFF on the CPU (``icp.align_multi``, the parity
    oracle)."""
    if use_fused_aligner is None:
        use_fused_aligner = _on_card(device)
    cfg = laser0_slam(num_beams, scene_capacity, use_fast_tracker=False)
    return dataclasses.replace(
        cfg, cue_extrinsics=tuple(tuple(float(v) for v in e) for e in cue_extrinsics),
        tracker=dataclasses.replace(cfg.tracker, use_fused_aligner=use_fused_aligner))


def default_config_manager(device=None):
    """What ``slam_app -j`` writes: the complete LASER_0 assembly under the
    names ``slam``, ``tracker``, ``aligner``, ``loop_detector``,
    ``closure_validator``, ``relocalizer``, ``global_solver`` and
    ``preprocessor``. ``use_fast_tracker`` follows ``device`` as in
    ``laser0_slam``."""
    mgr = config_mod.ConfigManager()
    slam_cfg = laser0_slam(device=device)
    mgr.add(slam_cfg, "slam")
    mgr.add(slam_cfg.tracker, "tracker")
    mgr.add(slam_cfg.tracker.aligner, "aligner")
    mgr.add(slam_cfg.detector, "loop_detector")
    mgr.add(slam_cfg.validator, "closure_validator")
    mgr.add(slam_cfg.relocalizer, "relocalizer")
    mgr.add(slam_cfg.global_solver, "global_solver")
    mgr.add(laser0_preprocessor(), "preprocessor")
    return mgr
