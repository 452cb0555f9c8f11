"""Message-driven SLAM runner over the per-message loop. Counterpart of
``srrg2_laser_slam_2d_tpu/models/runner.py``: the ``putMessage`` surface of
MultiGraphSLAM2D plus the odometry raw-data preprocessor and the sensor
extrinsic looked up in the TF tree. One laser topic (``scan_topic``) feeds
the single-cue loop; several (``scan_topics``, the MULTI assembly) feed the
multi-cue tracker, with each cue's extrinsic looked up in the TF tree on
the first frame (``sensor_frames``, ``base_frame``) unless the
configuration already holds ``cue_extrinsics``. A run resumes from a
checkpoint (``utils/checkpoint.py``) by skipping the frames it holds
(``skip_frames``; odometry and TF still reach the platform) and loading it
(``resume_checkpoint``) at the last skipped frame. ``draw`` renders the
map onto a ``viz/canvas.Canvas``.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np

from .._device import resolve_device
from ..io.messages import LaserMessage, OdometryMessage, extract_message
from ..io.sources import Platform
from ..utils import cloud as cloud_op
from ..utils import profiling
from .preprocessor import PreprocessorConfig, ScanPreprocessor
from .slam import GraphSLAM2D, GraphSLAMConfig, draw_map


@dataclass
class OdomPreprocessor:
    """RawDataPreprocessorOdom2D: the odometry pose of a topic."""

    topic: str = "/odom"

    def process(self, msg):
        odom = extract_message(msg, OdometryMessage, self.topic)
        return None if odom is None else np.asarray(odom.pose, np.float32)


@dataclass
class SlamRunner:
    """Drives ``GraphSLAM2D`` from a message source and collects the
    timestamped trajectory and per-frame timings. Runs on the CUDA card
    unless ``device`` says otherwise; without a card it raises
    (``device="cpu"`` runs the plain PyTorch versions)."""

    slam_config: GraphSLAMConfig = field(default_factory=GraphSLAMConfig)
    preprocessor_config: PreprocessorConfig = field(default_factory=PreprocessorConfig)
    scan_topic: str | None = None
    scan_topics: list | None = None
    sensor_frames: list | None = None
    odom_topic: str = "/odom"
    sensor_frame: str | None = None
    base_frame: str | None = None
    sensor_in_robot: np.ndarray | None = None
    skip_frames: int = 0
    resume_checkpoint: str | None = None
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.platform = Platform()
        self.preprocessor = ScanPreprocessor(self.preprocessor_config, device=self.device)
        self.odom_pre = OdomPreprocessor(self.odom_topic)
        self.slam: GraphSLAM2D | None = None
        self.trajectory: list = []   # (timestamp, pose, seconds)
        # seconds spent making clouds, all cues (the span ``runner.preprocess``,
        # synchronised only while tracing)
        self.preprocess_time = 0.0

    def _ensure_slam(self) -> GraphSLAM2D:
        if self.slam is None:
            if self.scan_topics and self.sensor_frames and self.base_frame:
                extrs = []
                for frame in self.sensor_frames:
                    tf = self.platform.get_transform(frame, self.base_frame)
                    if tf is None:
                        raise RuntimeError(f"no TF {frame} -> {self.base_frame} yet")
                    extrs.append(tuple(float(v) for v in tf))
                self.slam_config = dataclasses.replace(self.slam_config,
                                                       cue_extrinsics=tuple(extrs))
            extr = self.sensor_in_robot
            if extr is None and self.sensor_frame and self.base_frame:
                extr = self.platform.get_transform(self.sensor_frame, self.base_frame)
            self.slam = GraphSLAM2D(self.slam_config, sensor_in_robot=extr,
                                    device=self.device)
        return self.slam

    def _preprocess(self, laser: LaserMessage):
        with profiling.timed("runner.preprocess", self.device) as span:
            cloud = self.preprocessor.process_message(laser)
        self.preprocess_time += span.seconds
        return cloud

    def put_message(self, msg) -> bool:
        """Feed one message (or pack); True if a frame was processed. With
        ``scan_topics`` a pack must hold one laser message per topic (else it
        is skipped); their clouds are stacked [C, N, ...]."""
        self.platform.add(msg)
        if self.scan_topics:
            lasers = [extract_message(msg, LaserMessage, t) for t in self.scan_topics]
            if any(m is None for m in lasers):
                return False
            cloud = cloud_op.stack([self._preprocess(m) for m in lasers])
            laser = lasers[0]
        else:
            laser = extract_message(msg, LaserMessage, self.scan_topic)
            if laser is None:
                return False
            cloud = self._preprocess(laser)
        if self.skip_frames > 0:
            self.skip_frames -= 1
            if self.skip_frames == 0 and self.resume_checkpoint:
                from ..utils import checkpoint as ckpt

                ckpt.load(self.resume_checkpoint, self._ensure_slam())
                self.trajectory = [(t, p, 0.0)
                                   for t, p in ckpt.trajectory_from(self.resume_checkpoint)]
            return False
        odom = self.odom_pre.process(msg)
        slam = self._ensure_slam()
        t0 = time.perf_counter()
        slam.process(cloud, odom)
        pose = slam.robot_in_world()     # reads the pose back: the frame's work is done
        self.trajectory.append((laser.timestamp, pose, time.perf_counter() - t0))
        return True

    def run(self, source, max_frames: int | None = None) -> int:
        n = 0
        for msg in source:
            if self.put_message(msg):
                n += 1
                if max_frames is not None and n >= max_frames:
                    break
        return n

    def timing_summary(self) -> dict:
        ts = [d for _, _, d in self.trajectory]
        if not ts:
            return {"frames": 0}
        out = {"frames": len(ts), "total_compute_time": float(np.sum(ts)),
               "mean_frame_time": float(np.mean(ts)),
               "mean_frame_hz": float(1.0 / np.mean(ts)),
               "preprocess_time": self.preprocess_time}
        if self.slam is not None and self.slam.phase_times:
            out["phases"] = {k: round(v, 3) for k, v in self.slam.phase_times.items()}
        return out

    def draw(self, canvas) -> None:
        """The map: every local map's scene at its pose, the trajectory and
        the graph's edges (``slam.draw_map``)."""
        if self.slam is not None:
            draw_map(canvas, self.slam, self.trajectory)
