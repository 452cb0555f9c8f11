"""Message-driven SLAM runner over the per-message loop. Counterpart of
``srrg2_laser_slam_2d_tpu/models/runner.py`` (the ``putMessage`` surface of
MultiGraphSLAM2D plus the odometry raw-data preprocessor and the sensor
extrinsic looked up in the TF tree), single cue. Multi-cue input
(``scan_topics``) and resuming from a checkpoint (``resume_checkpoint``)
are not ported and raise.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .._device import resolve_device
from ..io.messages import LaserMessage, OdometryMessage, extract_message
from ..io.sources import Platform
from .preprocessor import LaserModel, PreprocessorConfig, ScanPreprocessor
from .slam import GraphSLAM2D, GraphSLAMConfig


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
    odom_topic: str = "/odom"
    sensor_frame: str | None = None
    base_frame: str | None = None
    sensor_in_robot: np.ndarray | None = None
    skip_frames: int = 0
    resume_checkpoint: str | None = None
    device: object = None

    def __post_init__(self):
        if self.scan_topics:
            raise NotImplementedError("multi-cue input (scan_topics) is not ported")
        if self.resume_checkpoint:
            raise NotImplementedError("resuming from a checkpoint is not ported")
        self.device = resolve_device(self.device)
        self.platform = Platform()
        self.preprocessor = ScanPreprocessor(self.preprocessor_config, device=self.device)
        self.odom_pre = OdomPreprocessor(self.odom_topic)
        self.slam: GraphSLAM2D | None = None
        self.trajectory: list = []   # (timestamp, pose, seconds)
        self.preprocess_time = 0.0   # seconds spent making clouds (not synchronised)

    def _ensure_slam(self) -> GraphSLAM2D:
        if self.slam is None:
            extr = self.sensor_in_robot
            if extr is None and self.sensor_frame and self.base_frame:
                extr = self.platform.get_transform(self.sensor_frame, self.base_frame)
            self.slam = GraphSLAM2D(self.slam_config, sensor_in_robot=extr,
                                    device=self.device)
        return self.slam

    def put_message(self, msg) -> bool:
        """Feed one message (or pack); True if a frame was processed."""
        self.platform.add(msg)
        laser = extract_message(msg, LaserMessage, self.scan_topic)
        if laser is None:
            return False
        self.preprocessor.set_model(LaserModel(
            num_beams=len(laser.ranges), angle_min=float(laser.angle_min),
            angle_max=float(laser.angle_max), range_min=float(laser.range_min),
            range_max=float(laser.range_max)))
        t_pre = time.perf_counter()
        cloud = self.preprocessor.compute(np.asarray(laser.ranges, np.float32))
        self.preprocess_time += time.perf_counter() - t_pre
        if self.skip_frames > 0:
            self.skip_frames -= 1
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
