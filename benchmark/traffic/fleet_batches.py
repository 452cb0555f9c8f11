"""Fleet re-tracking: K robots' logs tracked as K streams through the port's
K-stream frame kernel (``ops/stream_kernel.track_streams_grid``, kernel 3)
and scene materialization (``models/fast_tracker.materialize``).

The traffic (a ``traffic/<mix>.json`` of ``"generator": "fleet_batches"``):
``robots`` robots, each with its own seeded random walk of
``batches_per_drive`` x ``batch_frames`` steps in the circle-and-corner
world (the arithmetic of the port's ``bench/synthetic.simulate``, batched
over robots), scanned by a polar laser (``scanner``). Every scan is made,
preprocessed and packed into the kernel's canvas layout in set-up, on the
card, by the benchmark's own copy (``reference/prep.py``), so the program
and the reference get the same canvases.

Closed loop, one batch in flight: each call tracks the next batch of every
robot, materializes the K scenes, and reads the K poses back to the host;
the state is fed forward. When the drives end, every slot starts its log
again from the seed state of the drive's first scan.

End-to-end: ``fleet_scans_per_s`` (K x T scans a call over the window, from
its start to the last call's poses on the host) and ``fleet_batch_p95_ms``
(submission to the K poses on the host, over every call of the window).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

from ..reference import prep, stream
from ..reference.precision import computed_in

# a stream-frame's estimate, a scene row's point, counts as off beyond this
# (the port's kernel holds its plain version to 1e-3 away from bin edges)
POINT_TOL = 1e-3


def world_points(world: dict) -> np.ndarray:
    """The circle and the L-corner of ``bench/synthetic.make_scene``."""
    a = np.arange(world["circle_points"]) * (2 * np.pi / world["circle_points"])
    r = world["circle_radius"]
    circle = np.stack([r * np.cos(a), r * np.sin(a)], axis=1)
    l0, l1 = 2.0, 3.0
    n = world["corner_points"]
    step = (l0 + l1) / n
    n0 = int(l0 / step)
    seg0 = np.stack([step * np.arange(n0), np.zeros(n0)], axis=1)
    n1 = n - n0
    seg1 = np.stack([np.zeros(n1 - 1), -step * np.arange(1, n1)], axis=1)
    corner = np.concatenate([seg0, seg1], axis=0)
    c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
    corner = corner @ np.array([[c, -s], [s, c]]).T + np.array([2.0, 0.0])
    return np.concatenate([circle, corner], axis=0).astype(np.float32)


def _compose_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ca, sa = np.cos(a[..., 2]), np.sin(a[..., 2])
    t = a[..., 2] + b[..., 2]
    return np.stack([a[..., 0] + ca * b[..., 0] - sa * b[..., 1],
                     a[..., 1] + sa * b[..., 0] + ca * b[..., 1],
                     np.arctan2(np.sin(t), np.cos(t))], axis=-1)


def drives(rng: np.random.Generator, robots: int, steps: int, max_variance: float,
           sensor_in_robot) -> tuple[np.ndarray, np.ndarray]:
    """Each robot's seeded random walk from the origin, as in
    ``bench/synthetic.simulate`` -> (robot poses, sensor poses), [robots,
    steps + 1, 3] float32."""
    motion = rng.uniform(-0.5, 0.5, size=(steps, robots, 3)) * max_variance
    sir = np.asarray(sensor_in_robot, np.float64)
    robot = np.zeros((robots, 3))
    rp = [robot]
    for t in range(steps):
        robot = _compose_np(robot, motion[t])
        rp.append(robot)
    rp = np.stack(rp, axis=1)
    return rp.astype(np.float32), _compose_np(rp, sir).astype(np.float32)


def frame_spec(config: dict) -> stream.Spec:
    p = config["projection"]
    proj = prep.PolarProjection.make(p["cols"], p["angle_min"], p["angle_max"],
                                     p["range_min"], p["range_max"])
    fs = dict(config["frame_spec"])
    fs.pop("meas_as_canvas", None)
    return stream.Spec(projection=proj, **fs)


def port_spec(spec: stream.Spec):
    """The port's ``FrameSpec`` with the same settings."""
    from srrg2_laser_slam_2d_tpu_torch.ops.frame_kernel import FrameSpec
    from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection

    fields = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    fields["projection"] = PolarProjection(*spec.projection)
    return FrameSpec(meas_as_canvas=True, **fields)


class FleetInputs:
    """Every robot's drive, made from the seed on ``device``: the seed state
    from each drive's first scan and, per batch, the canvases [R, T, 8, K,
    B] and odometry [R, T, K, 8] in the kernel's layout."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.spec = frame_spec(config)
        K, T, R = mix["robots"], mix["batch_frames"], mix["batches_per_drive"]
        self.K, self.T, self.R = K, T, R
        B = self.spec.cols_padded
        sc = mix["scanner"]
        scan_proj = prep.PolarProjection.make(sc["num_beams"], sc["angle_min"],
                                              sc["angle_max"], sc["range_min"],
                                              sc["range_max"])
        rng = np.random.default_rng(seed)
        robot_np, sensor_np = drives(rng, K, R * T, mix["max_variance"],
                                     mix["sensor_in_robot"])
        pts = torch.from_numpy(world_points(mix["world"])).to(device)
        world = prep.Cloud(pts, torch.zeros_like(pts),
                           torch.ones(pts.shape[0], dtype=torch.bool, device=device))
        self.measC = torch.empty((R, T, 8, K, B), device=device)
        self.odom = torch.zeros((R, T, K, 8), device=device)
        robot = torch.from_numpy(robot_np).to(device)
        self.odom[..., 0:3] = robot[:, 1:].reshape(K, R, T, 3).permute(1, 2, 0, 3)
        self.odom[..., 3] = 1.0
        first = []
        step = max(1, mix.get("robots_per_block", 8))
        for k0 in range(0, K, step):
            k1 = min(K, k0 + step)
            poses = torch.from_numpy(sensor_np[k0:k1]).to(device)          # [k, S, 3]
            (depth, _, valid), _ = prep.project(
                scan_proj, poses, world.map(lambda x: x.expand((k1 - k0, poses.shape[1])
                                                               + x.shape)))
            ranges = torch.where(valid, depth, torch.zeros_like(depth))
            clouds = prep.preprocess(scan_proj, config["preprocessor"], ranges)
            first.append(clouds.map(lambda x: x[:, 0]))
            canv = prep.measurement_canvas(self.spec.projection, B,
                                           clouds.map(lambda x: x[:, 1:]))   # [k, RT, 8, B]
            self.measC[..., k0:k1, :] = canv.reshape(k1 - k0, R, T, 8, B).permute(1, 2, 3, 0, 4)
        first = prep.Cloud(*(torch.cat(f) for f in zip(*first)))
        cache, pose, scene = prep.seed_state(
            self.spec.projection, B, self.spec.scene_capacity, first,
            torch.tensor(mix["sensor_in_robot"], device=device), robot[:, 0])
        # the kernel's state layout: cache [8, K, B], pose [K, 16]
        self.cache0 = cache.permute(1, 0, 2).contiguous()
        self.pose0 = torch.zeros(K, 16, device=device)
        self.pose0[:, 0:8] = pose[:, 0]
        self.pose0[:, 8:11] = pose[:, 1, 0:3]
        self.scene0 = scene


@dataclasses.dataclass
class Call:
    """One call's inputs and outputs, kept for the check."""

    batch: int
    cache_in: torch.Tensor
    pose_in: torch.Tensor
    scene_in: prep.Cloud
    pose_out: torch.Tensor
    payloads: torch.Tensor
    scene_out: object


class FleetRun:
    """One run of a fleet cell: inputs in set-up, the closed loop in the
    window, the reference over a sampled call afterwards."""

    def __init__(self, config: dict, mix: dict, cell: dict, seed: int, device):
        from srrg2_laser_slam_2d_tpu_torch.models import fast_tracker as ft
        from srrg2_laser_slam_2d_tpu_torch.ops import stream_kernel as sk

        self.sk, self.ft = sk, ft
        self.device = device
        self.cell = cell
        self.inputs = FleetInputs(config, mix, seed, device)
        self.spec = self.inputs.spec
        self.pspec = port_spec(self.spec)
        self.rng = np.random.default_rng([seed, 1])
        self.calls = 0
        self.kept: Call | None = None
        self.latencies: list[float] = []
        self.nonfinite = self.failed_calls = 0
        self._reset()
        self.info = {"K": self.inputs.K, "T": self.inputs.T, "B": self.spec.cols_padded,
                     "iterations": self.spec.iterations,
                     "corr_refresh": self.spec.corr_refresh}

    def _reset(self) -> None:
        i = self.inputs
        self.cacheB, self.poseB, self.scenes, self.batch = i.cache0, i.pose0, i.scene0, 0

    def _call(self, spans=None):
        """Track the next batch of every robot, materialize, read the poses."""
        if self.batch == self.inputs.R:
            self._reset()
        b = self.batch
        cache_in, pose_in, scene_in = self.cacheB, self.poseB, self.scenes
        t0 = time.perf_counter()
        cB, pB, pay = self.sk.track_streams_grid(self.pspec, cache_in, pose_in,
                                                 self.inputs.measC[b], self.inputs.odom[b])
        with _span(spans, "fleet.materialize"):
            scenes = self.ft.materialize(self.pspec, scene_in, pay.movedim(2, 0), pB[:, 7])
        poses = pB[:, 0:3].to("cpu")
        t1 = time.perf_counter()
        bad = int((~torch.isfinite(poses)).any(-1).sum())
        self.nonfinite += bad
        self.failed_calls += int(bad > 0)
        self.cacheB, self.poseB, self.scenes = cB, pB, prep.Cloud(*scenes)
        self.batch += 1
        self.calls += 1
        # one call of the window, drawn from the seed (reservoir sampling)
        if self.rng.random() * self.calls < 1.0:
            self.kept = Call(b, cache_in, pose_in, scene_in, pB, pay, self.scenes)
        return t1 - t0, t1

    def warm_up(self) -> None:
        self._call()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.calls, self.kept, self.nonfinite, self.failed_calls = 0, None, 0, 0

    def run_window(self, seconds: float, spans=None) -> dict:
        t_start = time.perf_counter()
        t_end = t_start + seconds
        done = t_start
        while done < t_end:
            lat, done = self._call(spans)
            self.latencies.append(lat)
        window = done - t_start
        lat_ms = sorted(1e3 * x for x in self.latencies)
        p95 = lat_ms[min(len(lat_ms) - 1, math.ceil(0.95 * len(lat_ms)) - 1)]
        return {"fleet_scans_per_s": self.inputs.K * self.inputs.T * self.calls / window,
                "fleet_batch_p95_ms": p95}

    def attempted(self) -> int:
        return self.calls

    def failed(self) -> int:
        return self.failed_calls

    def release(self) -> None:
        """Free what the check does not read: the drives' other batches stay
        (the check reads the sampled one), the carried state goes."""
        self.cacheB = self.poseB = self.scenes = None

    def check(self, control_dtype=None) -> list[tuple[str, float, float]]:
        """The reference over the sampled call, from the program's state at
        its start -> [(name, number, limit)]. With ``control_dtype`` the
        reference computed in that dtype takes the program's place."""
        c = self.kept
        limits = self.cell["limits"]
        out = [("nonfinite_poses", float(self.nonfinite), float(limits["nonfinite_poses"]))]
        if c is None:
            return out + [("unchecked", 1.0, 0.0)]
        measC, odom = self.inputs.measC[c.batch], self.inputs.odom[c.batch]
        ref = reference_call(self.spec, c.cache_in, c.pose_in, c.scene_in, measC, odom)
        if control_dtype is not None:
            got = reference_call(self.spec, c.cache_in, c.pose_in, c.scene_in, measC, odom,
                                 dtype=control_dtype)
        else:
            got = (c.pose_out, c.payloads, c.scene_out)
        nums = compare_call(got, ref)
        return out + [(k, v, float(limits[k])) for k, v in nums.items()]


def _span(spans, name):
    return contextlib.nullcontext() if spans is None else spans(name)


def reference_call(spec: stream.Spec, cache_in, pose_in, scene_in, measC, odom, dtype=None):
    """The reference's (pose out, payloads, scene out) for one call; with
    ``dtype`` computed in it (the control), returned as float32."""
    with computed_in(dtype):
        cast = (lambda x: x) if dtype is None else (
            lambda x: x.to(dtype) if x.is_floating_point() else x)
        _, pB, pay = stream.track_streams(spec, cast(cache_in), cast(pose_in), cast(measC),
                                          cast(odom))
        scenes = stream.materialize(spec, scene_in.map(cast), pay.movedim(2, 0), pB[:, 7])
    f32 = (lambda x: x.float() if x.is_floating_point() else x)
    return f32(pB), f32(pay), prep.Cloud(*(f32(x) for x in scenes))


def compare_call(got, ref) -> dict:
    """The numbers that decide ``correct`` for one call of K streams x T
    frames: the share of stream-frames whose estimate is off by more than
    ``POINT_TOL``, the largest gap of the poses the call hands back, the
    share of live beams whose merge decision differs, the share of live
    scene rows that differ."""
    g_pose, g_pay, g_scene = got
    r_pose, r_pay, r_scene = ref
    est = (g_pay[:, 6, :, 0:3] - r_pay[:, 6, :, 0:3]).abs().amax(-1)           # [T, K]
    est = torch.where(torch.isfinite(est), est, torch.full_like(est, math.inf))
    live = (g_pay[:, 5] > 0) | (r_pay[:, 5] > 0)
    dec = live & ((g_pay[:, 5] != r_pay[:, 5]) | (g_pay[:, 4] != r_pay[:, 4]))
    rows = g_scene.valid | r_scene.valid
    pt = torch.cat([(g_scene.xy - r_scene.xy).abs(), (g_scene.normal - r_scene.normal).abs()],
                   -1).amax(-1)
    pt = torch.where(torch.isfinite(pt), pt, torch.full_like(pt, math.inf))
    row_off = rows & ((g_scene.valid != r_scene.valid) | (pt > POINT_TOL))
    pose_gap = (g_pose[:, 0:3] - r_pose[:, 0:3]).abs()
    pose_gap = torch.where(torch.isfinite(pose_gap), pose_gap, torch.full_like(pose_gap, math.inf))
    return {
        "estimate_off_share": float((est > POINT_TOL).float().mean()),
        "pose_gap": float(pose_gap.max()),
        "decision_off_share": float(dec.sum()) / max(float(live.sum()), 1.0),
        "scene_off_share": float(row_off.sum()) / max(float(rows.sum()), 1.0),
    }


def setup(cell, seed: int, device) -> FleetRun:
    return FleetRun(cell.config, cell.mix, cell.limits, seed, device)
