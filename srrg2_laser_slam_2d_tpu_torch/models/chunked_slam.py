"""Chunk-batched SLAM: the corridor gate's main path. Counterpart of
``srrg2_laser_slam_2d_tpu/models/chunked_slam.py``.

A chunk of frames goes through the frame kernel in ONE launch with the
local-map split decided in the kernel (``FrameSpec.split_distance``); the
host reads the [T, 12] stats once per chunk and from them rebuilds the
pose graph, materializes the scenes of every local map the chunk touched,
aligns every closure candidate of the maps born in the chunk (through the
NN-ICP kernel, one launch per ``detect_batch`` pairs, on the ``fused_nn``
backend; through batched projective ICP on ``projective``), votes, fuses the
accepted closures' scenes, solves the graph and relocalizes.

Scenes of all local maps live in one device pool [M, cap, ...]; the pose
graph is the base class's host bookkeeping, turned into a device graph at
solve time.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .._device import resolve_device
from ..ops import nn_icp_kernel
from ..ops.frame_kernel import track_frames_grid
from ..utils import profiling
from ..utils.cloud import Cloud
from . import fast_tracker as fast_mod
from . import loop_closure as lc
from .slam import GraphSLAM2D, GraphSLAMConfig, draw_map


def _bucket(n: int, lo: int = 8) -> int:
    """Smallest power of two >= max(n, lo)."""
    b = lo
    while b < n:
        b *= 2
    return b


class ChunkedGraphSLAM2D(GraphSLAM2D):
    """GraphSLAM2D with the chunk-batched loop; the kernel splits local maps
    at ``cfg.local_map_distance``."""

    def __init__(self, cfg: GraphSLAMConfig = GraphSLAMConfig(),
                 sensor_in_robot=None, chunk: int = 256, device=None):
        if cfg.cue_extrinsics is not None:
            raise ValueError("chunked loop is single-cue; use GraphSLAM2D")
        cfg = dataclasses.replace(cfg, use_fast_tracker=True, fast_canvas_meas=True)
        super().__init__(cfg, sensor_in_robot, device)
        self.chunk = chunk
        self.tracker.spec = dataclasses.replace(
            self.tracker.spec, split_distance=cfg.local_map_distance)
        self._X_host = np.zeros(3, np.float32)
        self.world_trajectory: list[np.ndarray] = []
        # live-point count of each local map (sizes the detection capacity)
        self._scene_counts: dict[int, int] = {}
        self._pool: Cloud | None = None
        # most candidate pairs one NN-ICP launch aligns
        self.detect_batch = 128
        # solved poses on the device, fetched at the next chunk's stats read
        self._pending_poses: torch.Tensor | None = None

    # ---- scene pool ---------------------------------------------------------
    def _pool_ensure(self, n: int) -> None:
        cap = self.tracker.spec.scene_capacity
        have = 0 if self._pool is None else self._pool.xy.shape[0]
        if have >= n:
            return
        m = max(64, _bucket(n))
        grow = Cloud(
            xy=torch.zeros(m - have, cap, 2, device=self.device),
            normal=torch.zeros(m - have, cap, 2, device=self.device),
            valid=torch.zeros(m - have, cap, dtype=torch.bool, device=self.device),
        )
        self._pool = grow if self._pool is None else Cloud(
            *(torch.cat([a, b]) for a, b in zip(self._pool, grow)))

    def _pool_write(self, ids: list[int], scenes: Cloud) -> None:
        """pool[ids] = scenes ([len(ids), cap, ...])."""
        self._pool_ensure(self.n_maps)
        idx = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
        for dst, src in zip(self._pool, scenes):
            dst[idx] = src

    def _pool_view(self, m: int) -> Cloud:
        """A copy of map m's scene: later pool writes must not reach it."""
        return self._pool.map(lambda x: x[m].clone())

    def robot_in_world(self) -> np.ndarray:
        if self.current_map < 0:
            return np.zeros(3, np.float32)
        return lc.compose_np(self.poses_np[self.current_map], self._X_host)

    @property
    def poses_np(self) -> np.ndarray:
        self._fetch_poses()
        return self._poses_host

    def _fetch_poses(self) -> None:
        if self._pending_poses is not None:
            self._poses_host = self._pending_poses.cpu().numpy()
            self._pending_poses = None

    def _global_solve(self) -> None:
        """With the relocalizer off nothing reads the poses before the next
        chunk, so their fetch waits for that chunk's stats read and the
        solve's last launches overlap the chunk's."""
        solved = self._solve_graph().poses[: self.n_maps]
        if self.cfg.enable_relocalizer:
            self._poses_host = solved.cpu().numpy()
        else:
            self._pending_poses = solved

    def scene_of(self, m: int) -> Cloud | None:
        """Scene of local map ``m``: the tracker's for the current map, else
        a copy of the pool's."""
        if m == self.current_map:
            return self.tracker.capture_scene()
        if self._pool is None or m >= self.n_maps:
            return None
        return self._pool_view(m)

    # ---- main entry ---------------------------------------------------------
    def process_chunk(self, clouds: Cloud, odoms: np.ndarray | None = None,
                      n_frames: int | None = None) -> np.ndarray:
        """Process a [T, ...] cloud stack on the SLAM device (+ [T, 3]
        odometry). Frames from ``n_frames`` on are padding. Returns the
        chunk's [n, 3] world-frame trajectory."""
        spec = self.tracker.spec
        dev = self.device
        T = clouds.xy.shape[0]
        n = T if n_frames is None else n_frames
        odom_valid = None
        if odoms is not None:
            odoms = np.asarray(odoms, np.float32)
            odom_valid = (np.arange(T) < n).astype(np.float32)

        with self._span("track"):
            first = self.current_map < 0
            if first:
                # frame 0 seeds local map 0
                self.current_map = self._add_variable(np.zeros(3, np.float32), fixed=True)
                self.tracker.state = fast_mod.seed(
                    spec, clouds.map(lambda x: x[0]), self.tracker.sensor_in_robot,
                    odom=None if odoms is None else odoms[0])
                self.world_trajectory.append(np.zeros(3, np.float32))
                # the chunk's grid drops frame 0 and pads one dead frame
                clouds_g = clouds.map(lambda x: torch.cat([x[1:], torch.zeros_like(x[:1])]))
                odoms_g = None if odoms is None else np.concatenate([odoms[1:], odoms[-1:]])
                ov_g = None if odoms is None else np.concatenate(
                    [odom_valid[1:], np.zeros(1, np.float32)])
                n_g = n - 1
            else:
                clouds_g, odoms_g, ov_g, n_g = clouds, odoms, odom_valid, n
            measC = fast_mod.pack_measurement_canvas_batch(
                spec, clouds_g,
                None if odoms_g is None else torch.from_numpy(odoms_g).to(dev),
                None if ov_g is None else torch.from_numpy(ov_g).to(dev))
            st = self.tracker.state
            cacheT, pose, payloads = track_frames_grid(spec, st.cacheT, st.pose, measC)
            self.tracker.state = st._replace(cacheT=cacheT, pose=pose)

            # ---- the chunk's one read of the kernel's stats -----------------
            stats = payloads[:, 6, :12].cpu().numpy()
            self._fetch_poses()
        if n_g <= 0:
            return np.zeros((0, 3), np.float32)
        with self._span("materialize"):
            stats = stats[:n_g]
            split_f = stats[:, 7] > 0.5
            X = stats[:, 8:11]
            counts = stats[:, 11]

            # ---- graph reconstruction + trajectory (host) -------------------
            cfg = self.cfg
            traj_map = np.empty(n_g, np.int64)
            seg_bounds: list[tuple[int, int, int]] = []   # (map, start, end) payloads
            cur = self.current_map
            start = 0    # payload segment start (a split frame seeds the new map)
            tstart = 0   # trajectory start (a split frame's X is in the old map)
            new_maps: list[int] = []
            for s in np.where(split_f)[0]:
                traj_map[tstart: s + 1] = cur
                ril = X[s]
                new = self._add_variable(lc.compose_np(self._poses_host[cur], ril))
                self._add_edge(cur, new, ril, cfg.odom_edge_info)
                seg_bounds.append((cur, start, int(s)))
                new_maps.append(new)
                cur, start, tstart = new, int(s), int(s) + 1
            traj_map[tstart:] = cur
            seg_bounds.append((cur, start, n_g))
            self.current_map = cur
            self._X_host = X[-1].copy() if not split_f[-1] else np.zeros(3, np.float32)

            P = self._poses_host[traj_map]
            c_, s_ = np.cos(P[:, 2]), np.sin(P[:, 2])
            world = np.stack([P[:, 0] + c_ * X[:, 0] - s_ * X[:, 1],
                              P[:, 1] + s_ * X[:, 0] + c_ * X[:, 1],
                              P[:, 2] + X[:, 2]], axis=1).astype(np.float32)
            self.world_trajectory.extend(world)

            # ---- scene materialization --------------------------------------
            # the first segment continues the entering map's scene
            m0, a0, b0 = seg_bounds[0]
            scene0 = self.tracker.state.scene
            if b0 > a0:
                scene0 = fast_mod.materialize(spec, scene0, payloads[:b0],
                                              float(counts[b0 - 1]))
                self._scene_counts[m0] = int(counts[b0 - 1])
            fresh = seg_bounds[1:]
            self._pool_write([m0], scene0.map(lambda x: x[None]))
            if fresh:
                # fresh maps: one batched materialize from empty scenes, the
                # segments padded to the longest with dead frames
                L = max(e - s for _, s, e in fresh)
                seg = torch.zeros((len(fresh), L) + payloads.shape[1:], device=dev)
                for k, (m, s, e) in enumerate(fresh):
                    seg[k, : e - s] = payloads[s:e]
                    self._scene_counts[m] = int(counts[e - 1])
                cap = spec.scene_capacity
                empty = Cloud(torch.zeros(len(fresh), cap, 2, device=dev),
                              torch.zeros(len(fresh), cap, 2, device=dev),
                              torch.zeros(len(fresh), cap, dtype=torch.bool, device=dev))
                scenes_k = fast_mod.materialize(
                    spec, empty, seg, torch.as_tensor(counts[[e - 1 for _, _, e in fresh]]))
                self._pool_write([m for m, _, _ in fresh], scenes_k)
                self.tracker.state = self.tracker.state._replace(
                    scene=scenes_k.map(lambda x: x[-1]))
            else:
                self.tracker.state = self.tracker.state._replace(scene=scene0)

        # ---- loop closures / solve / relocalize at the chunk boundary -------
        if cfg.enable_loop_closure and new_maps:
            with profiling.timed("slam.closure"):
                self._chunk_closure_round(new_maps)
        return world

    def _detect_pool(self, queries: list[int]) -> list[lc.ClosureCandidate]:
        """Closure detection for the query maps: candidate selection on the
        host, then the pool scenes aligned ``detect_batch`` pairs at a time
        (the NN-ICP kernel on the ``fused_nn`` backend, one batched projective
        ICP on ``projective``), and one read of all results."""
        dcfg = self.detector.cfg
        poses = self._poses_host
        with self._span("detect.select", phase=False):
            jobs = self.detector.selector.select_many(queries, poses, self.n_maps,
                                                      self.adjacency)
        if not jobs:
            return []
        cap = self.tracker.spec.scene_capacity
        det_cap = min(_bucket(max(self._scene_counts.get(m, cap)
                                  for m in range(self.n_maps)), lo=1024), cap)
        if dcfg.detection_capacity:
            det_cap = min(det_cap, dcfg.detection_capacity)
        acfg = dcfg.aligner
        packed = []
        for i in range(0, len(jobs), self.detect_batch):
            with self._span("detect.align", phase=False):
                batch = jobs[i: i + self.detect_batch]
                fi = torch.as_tensor([m for _, m in batch], device=self.device)
                qi = torch.as_tensor([q for q, _ in batch], device=self.device)
                fixed = self._pool.map(lambda x: x[fi, :det_cap])
                moving = self._pool.map(lambda x: x[qi, :det_cap])
                initials = torch.from_numpy(np.stack(
                    [lc.relative_np(poses[m], poses[q]) for q, m in batch])).to(self.device)
                if dcfg.backend == "fused_nn":
                    r = nn_icp_kernel.fused_align_pairs(
                        fixed, moving, initials,
                        iterations=acfg.max_iterations, max_distance=acfg.point_distance,
                        normal_cos=acfg.normal_cos, chi_threshold=acfg.chi_threshold,
                        min_inliers=acfg.min_num_inliers,
                        corr_refresh=dcfg.fused_corr_refresh)
                else:
                    r = lc._batch_align_pairs(acfg, self.detector.proj, fixed, moving,
                                              initials)
                packed.append(torch.cat([r.num_inliers[:, None].to(torch.float32),
                                         r.num_correspondences[:, None].to(torch.float32),
                                         r.chi_inliers[:, None], r.estimate], dim=1))
        with self._span("detect.gate", phase=False):
            res = torch.cat(packed).cpu().numpy()
            return lc.gate_candidates(dcfg, jobs, res[:, 0], res[:, 1], res[:, 2],
                                      res[:, 3:6])

    def _chunk_closure_round(self, new_maps: list[int]) -> None:
        cfg = self.cfg
        with self._span("detect"):
            for c in self._detect_pool(new_maps):
                self.validator.add(c)
        with self._span("vote"):
            accepted = self.validator.vote(self._poses_host, self.adjacency,
                                           list(self._edges_host))
        to_merge = []
        with self._span("merge"):
            for c in accepted:
                if c.candidate_map in self.adjacency[c.query_map]:
                    continue
                self._add_edge(c.candidate_map, c.query_map, c.estimate,
                               cfg.closure_edge_info)
                self.num_closures += 1
                to_merge.append(c)
            if cfg.enable_closure_merger and to_merge:
                self._merge_closures_batched(to_merge)
        if not to_merge:
            return
        with self._span("solve"):
            self._global_solve()
        if cfg.enable_relocalizer:
            with self._span("relocalize"):
                self._try_relocalize_host()

    def _merge_closures_batched(self, closures: list[lc.ClosureCandidate]) -> None:
        """Closure-time map fusion against the pool, batched per round;
        closures that share a candidate map go to later rounds, so the
        merges apply in order."""
        cfg = self.cfg
        cap = self.tracker.spec.scene_capacity
        remaining = list(closures)
        while remaining:
            seen: set[int] = set()
            group, later = [], []
            for c in remaining:
                (later if c.candidate_map in seen else group).append(c)
                seen.add(c.candidate_map)
            remaining = later
            ci = torch.as_tensor([c.candidate_map for c in group], device=self.device)
            qi = torch.as_tensor([c.query_map for c in group], device=self.device)
            est = torch.from_numpy(
                np.stack([c.estimate for c in group]).astype(np.float32)).to(self.device)
            fused = lc.merge_closure_scenes(
                cfg.tracker.projection, self._pool.map(lambda x: x[ci]),
                self._pool.map(lambda x: x[qi]), est,
                point_distance=cfg.detector.aligner.point_distance,
                normal_cos=cfg.detector.aligner.normal_cos,
                max_distance2=cfg.closure_merge_max_distance2,
                target_merges=cfg.closure_merge_target,
                binning=cfg.closure_merge_binning)
            self._pool_write([c.candidate_map for c in group], fused)
            for c in group:
                if c.candidate_map == self.current_map:
                    self.tracker.set_scene(self._pool_view(c.candidate_map),
                                           robot_in_local_map=self.tracker.robot_in_local_map)
                # a merge appends at most closure_merge_target points
                fx = self._scene_counts.get(c.candidate_map, cap)
                self._scene_counts[c.candidate_map] = min(cap, fx + cfg.closure_merge_target)

    def _try_relocalize_host(self) -> None:
        """After a closure, continue on the nearest adjacent older map within
        ``max_translation`` instead of the current one."""
        rcfg = self.cfg.relocalizer
        cur_w = self.robot_in_world()
        best, best_d = -1, rcfg.max_translation
        for m in range(self.n_maps):
            if m == self.current_map:
                continue
            d = float(np.linalg.norm(self._poses_host[m, :2] - cur_w[:2]))
            if d < best_d and m in self.adjacency[self.current_map]:
                best, best_d = m, d
        if best < 0:
            return
        ril = lc.relative_np(self._poses_host[best], cur_w)
        self._pool_write([self.current_map],
                         self.tracker.capture_scene().map(lambda x: x[None]))
        self.tracker.set_scene(self._pool_view(best), robot_in_local_map=ril)
        self.current_map = best
        self._X_host = ril
        self.relocalizations += 1


class ChunkedSlamRunner:
    """Message-driven wrapper over the chunked loop: laser frames buffer on
    the host and every ``chunk`` frames are processed as one chunk.

    Runs on the CUDA card unless ``device`` says otherwise; without a card
    it raises (``device="cpu"`` runs the plain PyTorch path)."""

    def __init__(self, slam_config: GraphSLAMConfig | None = None,
                 preprocessor_config=None, chunk: int = 256,
                 scan_topic: str | None = None, odom_topic: str = "/odom",
                 sensor_in_robot=None, device=None):
        from .preprocessor import PreprocessorConfig, ScanPreprocessor

        self.device = resolve_device(device)
        self.slam_config = slam_config or GraphSLAMConfig()
        self.preprocessor = ScanPreprocessor(preprocessor_config or PreprocessorConfig(),
                                             device=self.device)
        self.chunk = chunk
        self.scan_topic = scan_topic
        self.odom_topic = odom_topic
        self.sensor_in_robot = sensor_in_robot
        self.slam: ChunkedGraphSLAM2D | None = None
        self.trajectory: list = []        # (timestamp, pose, seconds per frame)
        self._ranges: list[np.ndarray] = []
        self._stamps: list[float] = []
        self._odoms: list[np.ndarray | None] = []
        self._last_odom: np.ndarray | None = None
        self._chunk_times: list[tuple[int, float]] = []

    def _ensure_slam(self) -> ChunkedGraphSLAM2D:
        if self.slam is None:
            self.slam = ChunkedGraphSLAM2D(self.slam_config, self.sensor_in_robot,
                                           chunk=self.chunk, device=self.device)
        return self.slam

    def put_message(self, msg) -> bool:
        """Feed one message; True if a laser frame was buffered."""
        from ..io.messages import LaserMessage, OdometryMessage, extract_message
        from .preprocessor import LaserModel

        odom = extract_message(msg, OdometryMessage, self.odom_topic)
        if odom is not None:
            self._last_odom = np.asarray(odom.pose, np.float32)
        laser = extract_message(msg, LaserMessage, self.scan_topic)
        if laser is None:
            return False
        self.preprocessor.set_model(LaserModel(
            num_beams=len(laser.ranges), angle_min=laser.angle_min,
            angle_max=laser.angle_max, range_min=laser.range_min,
            range_max=laser.range_max))
        self._ranges.append(np.asarray(laser.ranges, np.float32))
        self._stamps.append(float(laser.timestamp))
        self._odoms.append(self._last_odom)
        if len(self._ranges) >= self.chunk:
            self._flush(self.chunk)
        return True

    def _flush(self, n_pad: int) -> None:
        """Process the buffered frames as one chunk padded to ``n_pad``."""
        n = len(self._ranges)
        if n == 0:
            return
        t0 = time.perf_counter()
        with profiling.timed("runner.flush"):
            slam = self._ensure_slam()
            ranges = np.stack(self._ranges)
            if n < n_pad:
                ranges = np.pad(ranges, ((0, n_pad - n), (0, 0)))
            with profiling.timed("runner.preprocess", self.device, slam.phase_times,
                                 "preprocess"):
                clouds = self.preprocessor.compute(ranges)
            odoms = None
            if any(o is not None for o in self._odoms):
                prev = next(o for o in self._odoms if o is not None)
                filled = []
                for o in self._odoms:
                    prev = o if o is not None else prev
                    filled.append(prev)
                odoms = np.stack(filled)
                if n < n_pad:
                    odoms = np.concatenate([odoms, np.repeat(odoms[-1:], n_pad - n, axis=0)])
            slam.process_chunk(clouds, odoms, n_frames=n)
        dt = time.perf_counter() - t0
        per = dt / n
        poses = slam.world_trajectory[len(self.trajectory):]
        for ts, p in zip(self._stamps, poses):
            self.trajectory.append((ts, np.asarray(p), per))
        self._chunk_times.append((n, dt))
        self._ranges, self._stamps, self._odoms = [], [], []

    def finish(self) -> None:
        """Process a buffered partial chunk, padded with dead frames."""
        self._flush(self.chunk)

    def run(self, source, max_frames: int | None = None) -> int:
        n = 0
        for msg in source:
            if self.put_message(msg):
                n += 1
                if max_frames is not None and n >= max_frames:
                    break
        self.finish()
        return n

    def draw(self, canvas) -> None:
        """The map over the host-side graph (``slam.draw_map``)."""
        if self.slam is not None:
            draw_map(canvas, self.slam, self.trajectory)

    def timing_summary(self) -> dict:
        frames = sum(n for n, _ in self._chunk_times)
        total = sum(t for _, t in self._chunk_times)
        if frames == 0:
            return {"frames": 0}
        out = {"frames": frames, "total_compute_time": total,
               "mean_frame_time": total / frames, "mean_frame_hz": frames / total,
               "chunks": len(self._chunk_times), "chunk_size": self.chunk}
        if self.slam is not None and self.slam.phase_times:
            out["phases"] = {k: round(v, 3) for k, v in self.slam.phase_times.items()}
        return out
