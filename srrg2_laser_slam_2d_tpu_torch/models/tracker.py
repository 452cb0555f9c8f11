"""Scan-to-local-map tracker of the per-message loop. Counterpart of
``srrg2_laser_slam_2d_tpu/models/tracker.py`` (single cue): per frame clip
the local-map scene to the sensor's view, align the measurement against the
clip with the odometry prediction as initial guess and prior, update
``robot_in_local_map`` and merge the measurement into the scene.

Frames: the measurement lies in the sensor frame, the scene in the
local-map frame, the clip in the robot frame at the previous pose; the
aligner estimate T' maps that frame to the current sensor frame, and
X_new = X_old (S T')^-1 with S = sensor_in_robot.

``TrackerConfig`` picks the route: the plain projective ICP with the plain
clip and merge (all flags off), the banded aligner kernel
(``use_fused_aligner`` + ``banded_aligner``), the dense aligner kernel with
the scene canvas kernel (``use_fused_aligner`` + ``use_fused_scene_ops``),
each optionally with the merge canvas reused as the next clip
(``reuse_clip_canvas``) or the beam-sized lean merge (``lean_scene_ops``).

``MultiCueTracker`` tracks a robot with several rangefinders (the MULTI
assembly): each cue clips its own view of the scene, the clips are aligned
together against all cues' measurements (``icp.align_multi``, or the
multi-cue aligner kernel with ``use_fused_aligner``; the other route flags
do not apply) and each cue merges back through its own extrinsic.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops import clip as clip_op
from ..ops import icp
from ..ops import merge as merge_op
from ..ops.projector import PolarProjection
from ..utils import cloud as cloud_op
from ..utils import geometry
from ..utils.cloud import Cloud
from ..utils.status import Status


def default_projection() -> PolarProjection:
    """721 beams over +-pi, ranges [0.3, 20] m."""
    return PolarProjection.make(cols=721, angle_min=-math.pi, angle_max=math.pi,
                                range_min=0.3, range_max=20.0)


@dataclass(frozen=True)
class TrackerConfig:
    scene_capacity: int = 8192
    merge_threshold: float = 0.2
    clip_voxelize_resolution: float = 0.0
    projection: PolarProjection = field(default_factory=default_projection)
    aligner: icp.AlignerConfig = field(default_factory=icp.AlignerConfig)
    use_fused_aligner: bool = False
    banded_aligner: bool = False
    use_fused_scene_ops: bool = False
    clipper: str = "projective"
    ball_max_range: float = 10.0
    reuse_clip_canvas: bool = False
    lean_scene_ops: bool = False
    auto_grow_scene: bool = True
    grow_watermark: float = 0.9


class TrackerState(NamedTuple):
    """Tracker state, all tensors on one device."""

    scene: Cloud                        # local-map frame
    robot_in_local_map: torch.Tensor    # [3]
    last_odom: torch.Tensor             # [3] last odometry pose fed in
    has_odom: torch.Tensor              # [] bool
    sensor_in_robot: torch.Tensor       # [3]
    clip_cache: Cloud                   # [cols] post-merge beam canvas (sensor frame)
    clip_cache_rows: torch.Tensor       # [cols] scene row behind each canvas cell


class TrackStats(NamedTuple):
    estimate: torch.Tensor              # [3] aligner estimate
    chi: torch.Tensor
    num_correspondences: torch.Tensor
    num_inliers: torch.Tensor
    chi_inliers: torch.Tensor           # [] mean chi over the inliers (final pass)
    iterations: torch.Tensor
    iter_stats: torch.Tensor            # [max_iterations, 4]: chi, n_corr, n_inl, chi_inl_mean
    status: torch.Tensor                # [] Status code: SUCCESS iff min_num_inliers inliers
    scene_count: torch.Tensor           # [] post-merge scene occupancy
    scene_full: torch.Tensor            # [] bool
    dropped_appends: torch.Tensor       # [] appends that did not fit (-1 unknown)


def init_state(cfg: TrackerConfig, sensor_in_robot=None, device="cpu") -> TrackerState:
    dev = torch.device(device)
    S = torch.zeros(3, device=dev) if sensor_in_robot is None else torch.as_tensor(
        np.asarray(sensor_in_robot, np.float32), device=dev)
    return TrackerState(
        scene=cloud_op.empty(cfg.scene_capacity, dev),
        robot_in_local_map=torch.zeros(3, device=dev),
        last_odom=torch.zeros(3, device=dev),
        has_odom=torch.zeros((), dtype=torch.bool, device=dev),
        sensor_in_robot=S,
        clip_cache=cloud_op.empty(cfg.projection.cols, dev),
        clip_cache_rows=torch.full((cfg.projection.cols,), -1, dtype=torch.int64, device=dev),
    )


def populate(cfg: TrackerConfig, state: TrackerState, measurement: Cloud) -> TrackerState:
    """First frame of a local map: the measurement, moved into the
    local-map frame and compacted, seeds the scene."""
    sensor_in_lm = geometry.compose(state.robot_in_local_map, state.sensor_in_robot)
    meas_lm = cloud_op.transform(measurement, sensor_in_lm)
    return state._replace(scene=cloud_op.repad(meas_lm, cfg.scene_capacity))


def _align_fused(cfg: TrackerConfig, measurement: Cloud, clipped: Cloud,
                 T0: torch.Tensor) -> icp.AlignResult:
    """The aligner kernels (banded or dense) behind ``use_fused_aligner``."""
    if cfg.banded_aligner:
        if cfg.clipper != "projective" or cfg.clip_voxelize_resolution > 0:
            raise ValueError("banded_aligner needs a beam-indexed moving cloud "
                             "(projective clipper, no clip voxelization)")
        from ..ops.banded_align_kernel import fused_projective_align_banded as align_fn
    else:
        from ..ops.projective_align_kernel import fused_projective_align as align_fn
    a = cfg.aligner
    fres = align_fn(cfg.projection, measurement.xy, measurement.normal, measurement.valid,
                    clipped.xy, clipped.normal, clipped.valid, T0, odom_prior=T0,
                    iterations=a.max_iterations, point_distance=a.point_distance,
                    normal_cos=a.normal_cos, chi_threshold=a.chi_threshold,
                    min_inliers=a.min_num_inliers, odom_weight=a.odom_weight)
    return _fused_result(fres, a.max_iterations)


def _fused_result(fres, iterations: int) -> icp.AlignResult:
    """An aligner kernel's result as ``icp.AlignResult``: the inlier chi of
    the final pass and of every iteration record become means."""
    it_stats = fres.iter_stats.clone()
    it_stats[:, 3] = it_stats[:, 3] / torch.clamp(it_stats[:, 2], min=1.0)
    return icp.AlignResult(
        estimate=fres.estimate, chi=fres.chi,
        num_correspondences=fres.num_corr.to(torch.int64),
        num_inliers=fres.num_inliers.to(torch.int64),
        chi_inliers=fres.chi_inl_sum / torch.clamp(fres.num_inliers, min=1.0),
        iterations=torch.tensor(iterations, device=fres.estimate.device), stats=it_stats)


def track_step(cfg: TrackerConfig, state: TrackerState, measurement: Cloud,
               odom: torch.Tensor, odom_valid: torch.Tensor,
               use_clip_cache: bool = False) -> tuple[TrackerState, TrackStats]:
    """One tracking step. ``odom`` is the current odometry pose (any fixed
    odometry frame); ``odom_valid`` (0-d bool) gates the prior."""
    S = state.sensor_in_robot
    use_prior = state.has_odom & odom_valid
    D = torch.where(use_prior, geometry.relative(state.last_odom, odom), torch.zeros_like(S))
    T0 = geometry.inverse(geometry.compose(D, S))

    if use_clip_cache and cfg.reuse_clip_canvas:
        # the cache is last merge's post-merge canvas in the sensor frame at
        # exactly this frame's clip camera: re-frame it
        clipped = cloud_op.transform(state.clip_cache, S)
    elif cfg.clipper == "ball":
        clipped = clip_op.clip_ball(state.scene, state.robot_in_local_map, S,
                                    cfg.ball_max_range)
    elif cfg.use_fused_scene_ops:
        from ..ops import scene_kernel

        clipped = scene_kernel.clip_projective(cfg.projection, state.scene,
                                               state.robot_in_local_map, S)
    else:
        clipped = clip_op.clip_projective(cfg.projection, state.scene,
                                          state.robot_in_local_map, S,
                                          cfg.clip_voxelize_resolution)

    if cfg.use_fused_aligner:
        res = _align_fused(cfg, measurement, clipped, T0)
    else:
        res = icp.align(cfg.aligner, cfg.projection, fixed=measurement, moving=clipped,
                        initial=T0, odom_prior=T0)

    X_new = geometry.compose(state.robot_in_local_map,
                             geometry.inverse(geometry.compose(S, res.estimate)))
    cam = geometry.compose(X_new, S)
    clip_cache, clip_cache_rows = state.clip_cache, state.clip_cache_rows
    dropped = torch.tensor(-1, device=S.device)
    if cfg.lean_scene_ops and use_clip_cache:
        scene, clip_cache, clip_cache_rows = merge_op.merge_projective_lean(
            cfg.projection, state.scene, state.clip_cache, state.clip_cache_rows,
            measurement, old_sensor_in_new=geometry.compose(res.estimate, S),
            measurement_in_scene=cam, merge_threshold=cfg.merge_threshold)
    elif cfg.use_fused_scene_ops:
        from ..ops import scene_kernel

        out = scene_kernel.merge_projective(
            cfg.projection, state.scene, measurement, measurement_in_scene=cam,
            merge_threshold=cfg.merge_threshold, return_canvas=cfg.reuse_clip_canvas)
        if cfg.reuse_clip_canvas:
            scene, padded = out
            # the kernel's canvas is padded to a multiple of 128 beams
            clip_cache = padded.map(lambda x: x[: cfg.projection.cols])
        else:
            scene = out
    elif cfg.reuse_clip_canvas:
        scene, clip_cache, clip_cache_rows, dropped = merge_op.merge_projective(
            cfg.projection, state.scene, measurement, measurement_in_scene=cam,
            merge_threshold=cfg.merge_threshold, return_canvas=True, return_dropped=True)
    else:
        scene, dropped = merge_op.merge_projective(
            cfg.projection, state.scene, measurement, measurement_in_scene=cam,
            merge_threshold=cfg.merge_threshold, return_dropped=True)

    new_state = state._replace(
        scene=scene, robot_in_local_map=X_new,
        last_odom=torch.where(odom_valid, odom, state.last_odom),
        has_odom=state.has_odom | odom_valid,
        clip_cache=clip_cache, clip_cache_rows=clip_cache_rows)
    scene_count = scene.valid.sum()
    ok = res.num_inliers >= cfg.aligner.min_num_inliers
    stats = TrackStats(
        estimate=res.estimate, chi=res.chi, num_correspondences=res.num_correspondences,
        num_inliers=res.num_inliers, chi_inliers=res.chi_inliers,
        iterations=res.iterations, iter_stats=res.stats,
        status=torch.where(ok, int(Status.SUCCESS), int(Status.ERROR)),
        scene_count=scene_count, scene_full=scene_count >= scene.capacity,
        dropped_appends=dropped)
    return new_state, stats


def multi_step_inputs(cfg: TrackerConfig, state: TrackerState, extrinsics: torch.Tensor,
                      odom: torch.Tensor, odom_valid: torch.Tensor) -> tuple[Cloud, torch.Tensor]:
    """The moving cloud of one multi-cue step (each cue's clip of the scene,
    concatenated in the robot frame) and T0, the initial guess and the
    odometry prior: the inverse odometry step, or the identity without
    odometry."""
    use_prior = state.has_odom & odom_valid
    D = torch.where(use_prior, geometry.relative(state.last_odom, odom),
                    torch.zeros_like(state.last_odom))
    clips = [clip_op.clip_projective(cfg.projection, state.scene, state.robot_in_local_map,
                                     extrinsics[c], cfg.clip_voxelize_resolution)
             for c in range(extrinsics.shape[0])]
    return functools.reduce(cloud_op.concat, clips), geometry.inverse(D)


def fused_multi_arguments(cfg: TrackerConfig, measurements: Cloud, extrinsics: torch.Tensor,
                          moving: Cloud, T0: torch.Tensor) -> tuple[tuple, dict]:
    """The positional and keyword arguments of
    ``ops.multicue_align_kernel.fused_projective_align_multi`` (and of its
    plain version) for one multi-cue step."""
    a = cfg.aligner
    args = (cfg.projection, measurements.xy, measurements.normal, measurements.valid,
            extrinsics, moving.xy, moving.normal, moving.valid, T0)
    kw = dict(odom_prior=T0, iterations=a.max_iterations, point_distance=a.point_distance,
              normal_cos=a.normal_cos, chi_threshold=a.chi_threshold,
              min_inliers=a.min_num_inliers, min_corr=a.min_num_correspondences,
              odom_weight=a.odom_weight, damping=a.damping)
    return args, kw


def track_step_multi(cfg: TrackerConfig, state: TrackerState, measurements: Cloud,
                     extrinsics: torch.Tensor, odom: torch.Tensor,
                     odom_valid: torch.Tensor) -> tuple[TrackerState, TrackStats]:
    """One multi-cue tracking step. ``measurements`` [C, N, ...] holds the
    cues' clouds in their sensor frames, ``extrinsics`` [C, 3] their
    sensor-in-robot poses; the aligner estimate maps prev-robot ->
    curr-robot, so X_new = X_old estimate^-1."""
    n_cues = extrinsics.shape[0]
    moving, T0 = multi_step_inputs(cfg, state, extrinsics, odom, odom_valid)
    if cfg.use_fused_aligner:
        from ..ops.multicue_align_kernel import fused_projective_align_multi

        args, kw = fused_multi_arguments(cfg, measurements, extrinsics, moving, T0)
        res = _fused_result(fused_projective_align_multi(*args, **kw), cfg.aligner.max_iterations)
    else:
        res = icp.align_multi(cfg.aligner, cfg.projection, measurements, extrinsics, moving,
                              T0, odom_prior=T0)

    X_new = geometry.compose(state.robot_in_local_map, geometry.inverse(res.estimate))
    scene = state.scene
    for c in range(n_cues):
        scene = merge_op.merge_projective(
            cfg.projection, scene, measurements.map(lambda x: x[c]),
            measurement_in_scene=geometry.compose(X_new, extrinsics[c]),
            merge_threshold=cfg.merge_threshold)
    new_state = state._replace(
        scene=scene, robot_in_local_map=X_new,
        last_odom=torch.where(odom_valid, odom, state.last_odom),
        has_odom=state.has_odom | odom_valid)
    scene_count = scene.valid.sum()
    ok = res.num_inliers >= cfg.aligner.min_num_inliers
    stats = TrackStats(
        estimate=res.estimate, chi=res.chi, num_correspondences=res.num_correspondences,
        num_inliers=res.num_inliers, chi_inliers=res.chi_inliers,
        iterations=res.iterations, iter_stats=res.stats,
        status=torch.where(ok, int(Status.SUCCESS), int(Status.ERROR)),
        scene_count=scene_count, scene_full=scene_count >= scene.capacity,
        dropped_appends=torch.tensor(-1, device=X_new.device))
    return new_state, stats


def populate_multi(cfg: TrackerConfig, state: TrackerState, measurements: Cloud,
                   extrinsics: torch.Tensor) -> TrackerState:
    """Seed the scene from all cues at once, each moved into the local-map
    frame through its extrinsic."""
    scene = None
    for c in range(extrinsics.shape[0]):
        meas_lm = cloud_op.transform(measurements.map(lambda x: x[c]),
                                     geometry.compose(state.robot_in_local_map, extrinsics[c]))
        scene = meas_lm if scene is None else cloud_op.concat(scene, meas_lm)
    return state._replace(scene=cloud_op.repad(scene, cfg.scene_capacity))


class MultiCueTracker:
    """Stateful multi-rangefinder tracker with the surface the SLAM layer
    uses (``compute`` takes cue-stacked measurements [C, N, ...]). Runs on
    the CUDA card unless ``device`` says otherwise; without a card it raises
    (``device="cpu"`` runs the plain PyTorch versions). The scene keeps its
    capacity: there is no regrowth on this path."""

    def __init__(self, cfg: TrackerConfig, extrinsics, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.extrinsics = torch.as_tensor(np.asarray(extrinsics, np.float32),
                                          device=self.device)
        self.state = init_state(cfg, device=self.device)
        self._seeded = False
        self.steps = 0   # tracked frames

    @property
    def robot_in_local_map(self) -> torch.Tensor:
        return self.state.robot_in_local_map

    def _pose(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def set_scene(self, scene: Cloud, robot_in_local_map=None) -> None:
        """Continue tracking on an existing local-map scene (not written in
        place)."""
        self.state = self.state._replace(scene=scene.to(self.device))
        if robot_in_local_map is not None:
            self.state = self.state._replace(
                robot_in_local_map=self._pose(robot_in_local_map).clone())
        self._seeded = True

    def capture_scene(self) -> Cloud:
        return self.state.scene

    def reseed(self, measurements: Cloud, odom=None) -> None:
        """Start a new local map at the current measurements."""
        self.state = self.state._replace(robot_in_local_map=torch.zeros(3, device=self.device))
        self._seeded = False
        self.compute(measurements, odom)

    def compute(self, measurements: Cloud, odom=None) -> TrackStats | None:
        measurements = measurements.to(self.device)
        if not self._seeded:
            self.state = populate_multi(self.cfg, self.state, measurements, self.extrinsics)
            self._seeded = True
            if odom is not None:
                self.state = self.state._replace(
                    last_odom=self._pose(odom),
                    has_odom=torch.ones((), dtype=torch.bool, device=self.device))
            return None
        odom_t = self._pose(odom) if odom is not None else torch.zeros(3, device=self.device)
        odom_valid = torch.tensor(odom is not None, device=self.device)
        self.state, stats = track_step_multi(self.cfg, self.state, measurements,
                                             self.extrinsics, odom_t, odom_valid)
        self.steps += 1
        return stats


class LaserTracker:
    """Stateful wrapper with the tracker surface the SLAM layer uses. Runs
    on the CUDA card unless ``device`` says otherwise; without a card it
    raises (``device="cpu"`` runs the plain PyTorch versions)."""

    def __init__(self, cfg: TrackerConfig = TrackerConfig(), sensor_in_robot=None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = init_state(cfg, sensor_in_robot, self.device)
        self._seeded = False
        self._has_clip_cache = False
        # tracked frames, and how many of them took their clip from the cache
        self.steps = 0
        self.cached_clips = 0

    @property
    def robot_in_local_map(self) -> torch.Tensor:
        return self.state.robot_in_local_map

    def _pose(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def set_scene(self, scene: Cloud, robot_in_local_map=None) -> None:
        """Continue tracking on an existing local-map scene. The tracker
        never writes into a scene in place, so the caller's tensors stay as
        they are."""
        if scene.capacity != self.cfg.scene_capacity:
            # scenes may have been grown: keep the capacity in step
            self.cfg = dataclasses.replace(self.cfg, scene_capacity=scene.capacity)
        self.state = self.state._replace(scene=scene.to(self.device))
        if robot_in_local_map is not None:
            self.state = self.state._replace(
                robot_in_local_map=self._pose(robot_in_local_map).clone())
        self._seeded = True
        self._has_clip_cache = False

    def capture_scene(self) -> Cloud:
        """The current local-map scene."""
        return self.state.scene

    def reseed(self, measurement: Cloud, odom=None) -> None:
        """Start a new local map at the current measurement."""
        self.state = self.state._replace(
            robot_in_local_map=torch.zeros(3, device=self.device))
        self._seeded = False
        self.compute(measurement, odom)

    def compute(self, measurement: Cloud, odom=None) -> TrackStats | None:
        measurement = measurement.to(self.device)
        if not self._seeded:
            self.state = populate(self.cfg, self.state, measurement)
            self._seeded = True
            self._has_clip_cache = False
            if odom is not None:
                self.state = self.state._replace(
                    last_odom=self._pose(odom),
                    has_odom=torch.ones((), dtype=torch.bool, device=self.device))
            return None
        odom_t = self._pose(odom) if odom is not None else torch.zeros(3, device=self.device)
        odom_valid = torch.tensor(odom is not None, device=self.device)
        use_cache = self._has_clip_cache and self.cfg.reuse_clip_canvas
        self.state, stats = track_step(self.cfg, self.state, measurement, odom_t, odom_valid,
                                       use_clip_cache=use_cache)
        self.steps += 1
        self.cached_clips += int(use_cache)
        self._has_clip_cache = bool(self.cfg.reuse_clip_canvas)
        self._maybe_grow_scene(stats)
        return stats

    def _maybe_grow_scene(self, stats: TrackStats) -> None:
        """Double the scene's capacity once it fills past the watermark
        (the reference resizes dynamically)."""
        cfg = self.cfg
        if not cfg.auto_grow_scene:
            return
        if int(stats.scene_count) < cfg.grow_watermark * cfg.scene_capacity:
            return
        new_cap = cfg.scene_capacity * 2
        self.cfg = dataclasses.replace(cfg, scene_capacity=new_cap)
        self.state = self.state._replace(scene=cloud_op.repad(self.state.scene, new_cap))
