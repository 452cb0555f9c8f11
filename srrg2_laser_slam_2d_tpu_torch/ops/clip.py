"""Scene clipping: the sensor-visible slice of a local-map scene.
Counterpart of ``srrg2_laser_slam_2d_tpu/ops/clip.py``
(SceneClipperProjective2D, SceneClipperBall2D). The projective clip here
goes through ``projector.project`` (scatter, sort or kernel z-buffer);
``ops/scene_kernel.clip_projective`` is the one-kernel route.
"""

from __future__ import annotations

import torch

from ..utils import cloud as cloud_op
from ..utils import geometry
from ..utils.cloud import Cloud
from . import projector as projector_op
from .icp import _take
from .projector import PolarProjection


def clip_projective(proj: PolarProjection, scene: Cloud, robot_in_local_map: torch.Tensor,
                    sensor_in_robot: torch.Tensor, voxelize_resolution: float = 0.0) -> Cloud:
    """The z-buffer-visible cell of every beam of ``scene`` (local-map
    frame) seen from the sensor, returned in the ROBOT frame; one row per
    beam."""
    sensor_in_lm = geometry.compose(robot_in_local_map, sensor_in_robot)
    canvas, local = projector_op.project(proj, sensor_in_lm, scene)
    idx = torch.clamp(canvas.idx, min=0)
    clipped = Cloud(_take(local.xy, idx), _take(local.normal, idx), canvas.valid)
    if voxelize_resolution > 0:
        clipped = cloud_op.voxelize(clipped, voxelize_resolution, res_normal=0.1)
    return cloud_op.transform(clipped, sensor_in_robot)


def clip_ball(scene: Cloud, robot_in_local_map: torch.Tensor, sensor_in_robot: torch.Tensor,
              max_range: float = 10.0) -> Cloud:
    """Radial clip around the sensor origin, output in the robot frame."""
    sensor_in_lm = geometry.compose(robot_in_local_map, sensor_in_robot)
    kept = cloud_op.clip_ball(scene, sensor_in_lm[:2], max_range)
    return cloud_op.transform(kept, geometry.inverse(robot_in_local_map))
