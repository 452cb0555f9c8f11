"""Scan preprocessing: polar unprojection, sliding-window normals, voxel
decimation. Counterpart of ``srrg2_laser_slam_2d_tpu/models/preprocessor.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .._device import resolve_device
from ..ops import normals as normals_op
from ..ops import projector as projector_op
from ..utils import cloud as cloud_op
from ..utils.cloud import Cloud
from ..utils.status import Status


@dataclass(frozen=True)
class PreprocessorConfig:
    range_min: float = 0.0
    range_max: float = 1000.0
    voxelize_resolution: float = 0.02
    normal_point_distance: float = 0.3
    normal_min_points: int = 5
    normal_window: int = 16
    scan_topic: str = "/scan"
    # "grid" = exact 4D-cell mean, "sequential" = consecutive same-cell runs
    voxelize_mode: str = "grid"


@dataclass(frozen=True)
class LaserModel:
    """Static per-sensor metadata of a LaserMessage."""

    num_beams: int
    angle_min: float
    angle_max: float
    range_min: float
    range_max: float

    def projection(self, cfg: PreprocessorConfig) -> projector_op.PolarProjection:
        res = (self.angle_max - self.angle_min) / self.num_beams
        return projector_op.PolarProjection.make(
            cols=self.num_beams, angle_min=self.angle_min,
            angle_max=self.angle_max,
            range_min=max(self.range_min, cfg.range_min),
            range_max=min(self.range_max, cfg.range_max),
            f=1.0 / res, c=self.num_beams / 2.0,
        )


def preprocess_scan(proj: projector_op.PolarProjection, cfg: PreprocessorConfig,
                    ranges: torch.Tensor) -> Cloud:
    """ranges [..., num_beams] -> point-normal clouds in the sensor frame.
    Leading dimensions batch scans (the "grid" mode loops over them)."""
    cloud = projector_op.unproject(proj, ranges)
    cloud = normals_op.compute_normals(
        cloud, normal_point_distance=cfg.normal_point_distance,
        normal_min_points=cfg.normal_min_points, window=cfg.normal_window,
    )
    if cfg.voxelize_resolution <= 0:
        return cloud_op.compact(cloud)
    if cfg.voxelize_mode == "sequential":
        return cloud_op.voxelize_sequential(cloud, cfg.voxelize_resolution, 1.0)
    if cloud.xy.dim() == 2:
        return cloud_op.voxelize(cloud, cfg.voxelize_resolution, 1.0)
    flat = cloud.map(lambda x: x.reshape((-1,) + x.shape[len(ranges.shape) - 1:]))
    outs = [cloud_op.voxelize(Cloud(*(f[i] for f in flat)),
                              cfg.voxelize_resolution, 1.0)
            for i in range(flat.xy.shape[0])]
    stacked = Cloud(*(torch.stack(fs) for fs in zip(*outs)))
    return stacked.map(lambda x: x.reshape(ranges.shape[:-1] + x.shape[1:]))


class ScanPreprocessor:
    """Host-side adaptor: feed laser models and ranges (or laser messages),
    get masked clouds."""

    def __init__(self, cfg: PreprocessorConfig = PreprocessorConfig(),
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._model: LaserModel | None = None
        self._proj: projector_op.PolarProjection | None = None
        # the stage's status (ERROR / READY / SUCCESS), read lazily so that
        # the loop pays no device read for it
        self._last_output: Cloud | None = None
        self._error = False

    def set_model(self, model: LaserModel) -> None:
        if model != self._model:
            self._model = model
            self._proj = model.projection(self.cfg)

    @property
    def projection(self) -> projector_op.PolarProjection:
        if self._proj is None:
            raise RuntimeError("no laser model set")
        return self._proj

    @property
    def status(self) -> Status:
        """ERROR after a failed call or an empty cloud, READY before the
        first call, SUCCESS after a cloud with points (every cloud of a
        batch)."""
        if self._error:
            return Status.ERROR
        if self._last_output is None:
            return Status.READY
        return Status.SUCCESS if bool((self._last_output.count() > 0).all()) else Status.ERROR

    def compute(self, ranges) -> Cloud:
        if self._proj is None:
            self._error = True
            raise RuntimeError("no laser model set")
        r = torch.as_tensor(ranges, dtype=torch.float32, device=self.device)
        out = preprocess_scan(self._proj, self.cfg, r)
        self._last_output = out
        self._error = False
        return out

    def process_message(self, msg) -> Cloud:
        """The cloud of a ``LaserMessage`` (duck-typed): its laser model,
        then its ranges."""
        self.set_model(LaserModel(
            num_beams=len(msg.ranges), angle_min=float(msg.angle_min),
            angle_max=float(msg.angle_max), range_min=float(msg.range_min),
            range_max=float(msg.range_max)))
        return self.compute(msg.ranges)
