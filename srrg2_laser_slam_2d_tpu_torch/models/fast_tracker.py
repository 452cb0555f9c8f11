"""Fast tracking path around the fused frame kernel: beam-sized carried
state, one kernel launch per chunk of frames, deferred scene
materialization. Counterpart of
``srrg2_laser_slam_2d_tpu/models/fast_tracker.py``.

The scene is not updated per frame. Every frame emits an [8, B] payload
(merge / replace / append decisions with their final scene rows, assigned
in the kernel from the carried count), and ``materialize`` folds any
number of payloads into the scene at once, the last write to a row
winning. The canvas pack is plain PyTorch, as it is XLA code in the JAX
package; ``materialize`` (XLA code there too) is a CUDA kernel on the card,
with its plain version on the CPU (``ops/materialize_kernel.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops import materialize_kernel
from ..ops import projector as projector_op
from ..ops.frame_kernel import FrameSpec, frame_step, track_frames_grid
from ..utils import cloud as cloud_op
from ..utils import geometry
from ..utils import profiling
from ..utils.cloud import Cloud


class FastState(NamedTuple):
    """Carried state of the fast tracker."""

    cacheT: torch.Tensor   # [8, B] canvas cells, current sensor frame
    pose: torch.Tensor     # [2, 8] X / last_odom / has_odom / count / S
    scene: Cloud           # materialized scene (local-map frame)


def _take(x: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """Column k of rows idx of x [..., N, 2]."""
    return torch.gather(x[..., k], -1, idx)


def pack_measurement_canvas_batch(spec: FrameSpec, clouds: Cloud,
                                  odoms: torch.Tensor | None = None,
                                  odom_valid: torch.Tensor | None = None) -> torch.Tensor:
    """[T, N, ...] clouds (+ [T, 3] odometry) -> [T, 8, B] pre-z-buffered
    canvases: rows 0 depth, 1 x, 2 y, 3 nx, 4 ny, 5 has, row 6 lanes 0-3 =
    [odom x, y, theta, odom_valid], row 7 zero. Closest depth wins a beam,
    the lowest point index wins ties."""
    proj = spec.projection
    canvas = projector_op.project_local(proj, clouds)
    idx = torch.clamp(canvas.idx, min=0)
    T, dev = canvas.depth.shape[0], canvas.depth.device
    B = spec.cols_padded
    out = torch.zeros(T, 8, B, dtype=torch.float32, device=dev)
    out[:, 0, :proj.cols] = torch.where(canvas.valid, canvas.depth,
                                        torch.zeros_like(canvas.depth))
    out[:, 1, :proj.cols] = _take(clouds.xy, idx, 0)
    out[:, 2, :proj.cols] = _take(clouds.xy, idx, 1)
    out[:, 3, :proj.cols] = _take(clouds.normal, idx, 0)
    out[:, 4, :proj.cols] = _take(clouds.normal, idx, 1)
    out[:, 5, :proj.cols] = canvas.valid.to(torch.float32)
    if odoms is not None:
        out[:, 6, 0:3] = torch.as_tensor(odoms, dtype=torch.float32, device=dev)
        out[:, 6, 3] = (1.0 if odom_valid is None else
                        torch.as_tensor(odom_valid, dtype=torch.float32, device=dev))
    return out


def pack_measurement_batch(clouds: Cloud, odoms: torch.Tensor | None = None,
                           odom_valid: torch.Tensor | None = None) -> torch.Tensor:
    """[T, N, ...] clouds (+ [T, 3] odometry) -> [T, N, 8] raw kernel rows
    (x, y, nx, ny, valid, 0, 0, 0), the ``meas_as_canvas=False`` layout: the
    kernel z-buffers them itself. Column 5 of rows 0-3 carries [odom x, y,
    theta, odom_valid] (valid defaults to 1 where odometry is given)."""
    T, n = clouds.xy.shape[:2]
    dev = clouds.xy.device
    out = torch.zeros(T, n, 8, dtype=torch.float32, device=dev)
    out[..., 0:2] = clouds.xy
    out[..., 2:4] = clouds.normal
    out[..., 4] = clouds.valid.to(torch.float32)
    if odoms is not None:
        out[:, 0:3, 5] = torch.as_tensor(odoms, dtype=torch.float32, device=dev)
        out[:, 3, 5] = (1.0 if odom_valid is None else
                        torch.as_tensor(odom_valid, dtype=torch.float32, device=dev))
    return out


def pack_measurement(cloud: Cloud, odom=None, odom_valid=False) -> torch.Tensor:
    """One cloud -> its [N, 8] raw rows (``pack_measurement_batch``)."""
    batch = cloud.map(lambda x: x[None])
    if odom is None:
        return pack_measurement_batch(batch)[0]
    dev = cloud.xy.device
    odom = torch.as_tensor(np.array(odom, np.float32), device=dev)[None]
    valid = torch.tensor([float(odom_valid)], device=dev)
    return pack_measurement_batch(batch, odom, valid)[0]


def pack_measurement_canvas(spec: FrameSpec, cloud: Cloud, odom=None,
                            odom_valid=False) -> torch.Tensor:
    """One cloud -> its [8, B] canvas (``pack_measurement_canvas_batch``)."""
    batch = cloud.map(lambda x: x[None])
    if odom is None:
        return pack_measurement_canvas_batch(spec, batch)[0]
    dev = cloud.xy.device
    odom = torch.as_tensor(np.asarray(odom, np.float32), device=dev)[None]
    valid = torch.tensor([float(odom_valid)], device=dev)
    return pack_measurement_canvas_batch(spec, batch, odom, valid)[0]


def _state_from_scene(spec: FrameSpec, scene: Cloud, X: torch.Tensor,
                      S: torch.Tensor, last_odom: torch.Tensor,
                      has_odom: torch.Tensor) -> FastState:
    """Cache canvas of ``scene`` seen from the sensor at X S, and the pose
    block: the state the kernel carries."""
    proj = spec.projection
    dev = scene.xy.device
    canvas, local = projector_op.project(proj, geometry.compose(X, S), scene)
    idx = torch.clamp(canvas.idx, min=0)
    B = spec.cols_padded
    cacheT = torch.zeros(8, B, dtype=torch.float32, device=dev)
    cacheT[0, :proj.cols] = _take(local.xy, idx, 0)
    cacheT[1, :proj.cols] = _take(local.xy, idx, 1)
    cacheT[2, :proj.cols] = _take(local.normal, idx, 0)
    cacheT[3, :proj.cols] = _take(local.normal, idx, 1)
    cacheT[4, :proj.cols] = canvas.valid.to(torch.float32)
    cacheT[5, :proj.cols] = torch.where(canvas.valid, idx,
                                        torch.full_like(idx, -1)).to(torch.float32)
    cacheT[5, proj.cols:] = -1.0
    pose = torch.zeros(2, 8, dtype=torch.float32, device=dev)
    pose[0, 0:3] = X
    pose[0, 3:6] = last_odom
    pose[0, 6] = has_odom
    pose[0, 7] = scene.count().to(torch.float32)
    pose[1, 0:3] = S
    return FastState(cacheT=cacheT, pose=pose, scene=scene)


def _vec(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def seed(spec: FrameSpec, measurement: Cloud, sensor_in_robot,
         robot_in_local_map=None, odom=None) -> FastState:
    """First frame of a local map: the measurement becomes the scene (in
    the local-map frame) and the initial cache."""
    dev = measurement.xy.device
    X = _vec(np.zeros(3) if robot_in_local_map is None else robot_in_local_map, dev)
    S = _vec(sensor_in_robot, dev)
    meas_lm = cloud_op.compact(cloud_op.transform(measurement, geometry.compose(X, S)))
    scene = cloud_op.repad(meas_lm, spec.scene_capacity)
    last_odom = _vec(np.zeros(3) if odom is None else odom, dev)
    has = torch.tensor(0.0 if odom is None else 1.0, device=dev)
    return _state_from_scene(spec, scene, X, S, last_odom, has)


def seed_from_scene(spec: FrameSpec, scene: Cloud, robot_in_local_map,
                    sensor_in_robot, last_odom, has_odom) -> FastState:
    """Rebuild the cache from an existing scene (relocalization onto an
    older local map)."""
    dev = scene.xy.device
    return _state_from_scene(
        spec, scene, _vec(robot_in_local_map, dev), _vec(sensor_in_robot, dev),
        torch.as_tensor(last_odom, dtype=torch.float32, device=dev),
        torch.as_tensor(has_odom, dtype=torch.float32, device=dev))


@profiling.span("tracker.materialize")
def materialize(spec: FrameSpec, scene: Cloud, payloads: torch.Tensor,
                final_count) -> Cloud:
    """Fold [..., T, 8, B] payloads into scenes [..., cap, ...]: for each
    scene row the last write (highest frame, then highest lane) wins; the
    first ``final_count`` rows are valid. Leading dimensions batch scenes.
    CUDA tensors launch ``csrc/materialize_kernel.cu``; CPU tensors take
    the plain version (``ops/materialize_kernel.py``)."""
    return materialize_kernel.materialize(spec, scene, payloads, final_count)


class FastTracker:
    """Stateful wrapper around the fused frame kernel with the tracker
    surface the SLAM layer uses."""

    def __init__(self, spec: FrameSpec, sensor_in_robot=None, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.sensor_in_robot = (np.zeros(3, np.float32) if sensor_in_robot is None
                                else np.asarray(sensor_in_robot, np.float32))
        self.state: FastState | None = None
        self._pending: list[torch.Tensor] = []
        self._last_payload: torch.Tensor | None = None

    @property
    def robot_in_local_map(self) -> torch.Tensor:
        if self.state is None:
            return torch.zeros(3, device=self.device)
        return self.state.pose[0, 0:3]

    @property
    def scene(self) -> Cloud:
        """The current scene, pending payloads applied."""
        self.flush()
        return self.state.scene

    def flush(self) -> None:
        """Apply pending frame payloads to the scene."""
        if not self._pending:
            return
        payloads = torch.stack(self._pending)
        self._pending = []
        scene = materialize(self.spec, self.state.scene, payloads, self.state.pose[0, 7])
        self.state = self.state._replace(scene=scene)

    def capture_scene(self) -> Cloud:
        return self.scene

    def reseed(self, measurement: Cloud, odom=None) -> None:
        """Start a new local map at the current measurement."""
        self._pending = []
        prev = self.state
        self.state = seed(self.spec, measurement.to(self.device), self.sensor_in_robot,
                          odom=odom)
        if prev is not None and odom is None:
            # keep odometry continuity across the split
            pose = self.state.pose.clone()
            pose[0, 3:7] = prev.pose[0, 3:7]
            self.state = self.state._replace(pose=pose)

    def set_scene(self, scene: Cloud, robot_in_local_map=None) -> None:
        """Continue tracking on an existing local-map scene."""
        self._pending = []
        X = np.zeros(3, np.float32) if robot_in_local_map is None else \
            np.asarray(torch.as_tensor(robot_in_local_map).cpu(), np.float32)
        if self.state is not None:
            last_odom, has_odom = self.state.pose[0, 3:6], self.state.pose[0, 6]
        else:
            last_odom = torch.zeros(3, device=self.device)
            has_odom = torch.zeros((), device=self.device)
        self.state = seed_from_scene(self.spec, scene, X, self.sensor_in_robot,
                                     last_odom, has_odom)

    def compute(self, measurement: Cloud, odom=None):
        """Track one frame (one launch); returns the frame's stats lanes
        [T'(3), chi, n_corr, n_inliers, n_app]."""
        if self.state is None:
            self.state = seed(self.spec, measurement.to(self.device), self.sensor_in_robot,
                              odom=odom)
            return None
        pack = (functools.partial(pack_measurement_canvas, self.spec)
                if self.spec.meas_as_canvas else pack_measurement)
        measF = pack(measurement.to(self.device),
                     odom if odom is not None else np.zeros(3, np.float32), odom is not None)
        cacheT, pose, payload = frame_step(self.spec, measF, self.state.cacheT,
                                           self.state.pose)
        self.state = self.state._replace(cacheT=cacheT, pose=pose)
        self._pending.append(payload)
        self._last_payload = payload
        return payload[6, :7]

    def iteration_stats(self) -> torch.Tensor | None:
        """[iterations, 2]: chi and inliers of each Gauss-Newton iteration
        of the last tracked frame (None before one)."""
        if self._last_payload is None:
            return None
        return iteration_stats(self.spec, self._last_payload)


def iteration_stats(spec: FrameSpec, payload: torch.Tensor) -> torch.Tensor:
    """Decode payload row 7 of one frame ([8, B]): chi in lanes [0:its],
    inliers in lanes [64:64+its] -> [its, 2]."""
    its = spec.iterations
    row = payload[7]
    return torch.stack([row[0:its], row[64:64 + its]], dim=1)


def track_sequence_fast(spec: FrameSpec, state: FastState, measF_stack: torch.Tensor):
    """Bulk sequential tracking: the whole [T, 8, B] stack as one launch of
    the frame kernel, the scene materialized once at the end. Returns
    (state', stats [T, 7])."""
    cacheT, pose, payloads = track_frames_grid(spec, state.cacheT, state.pose, measF_stack)
    scene = materialize(spec, state.scene, payloads, pose[0, 7])
    return FastState(cacheT=cacheT, pose=pose, scene=scene), payloads[:, 6, :7]
