"""Top-level graph SLAM: configuration, the local-map graph and the
per-message loop. Counterpart of ``srrg2_laser_slam_2d_tpu/models/slam.py``
(MultiGraphSLAM2D): the same ``GraphSLAMConfig`` (so both packages read one
file) and ``GraphSLAM2D.process(measurement, odom)``:

  track -> split local maps on the distance criterion
        -> detect loop closures (batched candidate alignment)
        -> validate closures (vote) -> add edges -> global pose-graph solve
        -> relocalize onto existing maps

``robot_in_world = local_map_pose * robot_in_local_map``. Control flow that
depends on the data (splits, closures, relocalization jumps) runs on the
host, so the loop reads the tracker's pose back once per frame; the numeric
work (tracking step, batched closure alignment, pose-graph solve) runs on
the device. ``ChunkedGraphSLAM2D`` (``models/chunked_slam.py``) builds on
this class and replaces the per-message loop by one launch per chunk.

The pose graph is host bookkeeping (lists that grow as needed, where the
JAX package doubles static arrays); ``graph`` is the device graph at
power-of-two capacities, built when a solve needs it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..ops.frame_kernel import FrameSpec
from ..solver import cg, pgo, schur
from ..utils import profiling
from ..utils.cloud import Cloud
from . import fast_tracker as fast_mod
from . import loop_closure as lc
from . import tracker as tracker_mod


@dataclass(frozen=True)
class GraphSLAMConfig:
    local_map_distance: float = 1.0
    var_capacity: int = 1024
    edge_capacity: int = 4096
    odom_edge_info: tuple = (100.0, 100.0, 1000.0)
    closure_edge_info: tuple = (100.0, 100.0, 1000.0)
    tracker: tracker_mod.TrackerConfig = field(default_factory=tracker_mod.TrackerConfig)
    detector: lc.LoopDetectorConfig = field(default_factory=lc.LoopDetectorConfig)
    validator: lc.ValidatorConfig = field(default_factory=lc.ValidatorConfig)
    relocalizer: lc.RelocalizerConfig = field(default_factory=lc.RelocalizerConfig)
    global_solver: pgo.PGOConfig = field(default_factory=pgo.PGOConfig)
    global_solver_kind: str = "dense"
    schur_partitions: int = 8
    enable_loop_closure: bool = True
    enable_relocalizer: bool = True
    enable_closure_merger: bool = True
    closure_merge_max_distance2: float = 0.25
    closure_merge_target: int = 200
    closure_merge_binning: bool = True
    cue_extrinsics: tuple | None = None
    use_fast_tracker: bool = False
    fast_canvas_meas: bool = True


def frame_spec(cfg: GraphSLAMConfig) -> FrameSpec:
    """The frame kernel's static configuration from the tracker config."""
    t = cfg.tracker
    return FrameSpec(
        projection=t.projection, scene_capacity=t.scene_capacity,
        iterations=t.aligner.max_iterations, point_distance=t.aligner.point_distance,
        normal_cos=t.aligner.normal_cos, chi_threshold=t.aligner.chi_threshold,
        min_inliers=t.aligner.min_num_inliers, odom_weight=t.aligner.odom_weight,
        merge_threshold=t.merge_threshold, meas_as_canvas=cfg.fast_canvas_meas,
    )


# scene colors of successive local maps in ``draw_map``
MAP_COLORS = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b")


def draw_map(canvas, slam, trajectory) -> None:
    """Draw a SLAM run (MultiGraphSLAM2D::draw): each local map's reference
    frame and scene at its pose, the (timestamp, pose, ...) trajectory, and
    the graph's edges between the maps' positions."""
    poses = slam.poses_np
    for m in range(slam.n_maps):
        canvas.push_matrix()
        canvas.mult_matrix(poses[m])
        canvas.put_reference_system(0.3)
        scene = slam.scene_of(m)
        if scene is not None:
            canvas.put_cloud(scene, color=MAP_COLORS[m % len(MAP_COLORS)])
        canvas.pop_matrix()
    if trajectory:
        canvas.put_trajectory(np.stack([p for _, p, _ in trajectory]))
    ei = np.array([e[0] for e in slam._edges_host], np.int64)
    ej = np.array([e[1] for e in slam._edges_host], np.int64)
    canvas.put_segments(poses[ei, :2], poses[ej, :2], color="gray")


def _wrap(pose: np.ndarray) -> np.ndarray:
    """The pose with its angle wrapped to (-pi, pi], as ``geometry.compose``
    returns it."""
    out = np.asarray(pose, np.float32).copy()
    out[2] = np.arctan2(np.sin(out[2]), np.cos(out[2]))
    return out


class GraphSLAM2D:
    """Stateful SLAM orchestrator: ``process(measurement, odom)`` per
    message. Runs on the CUDA card unless ``device`` says otherwise; without
    a card it raises (``device="cpu"`` runs the plain PyTorch versions)."""

    def __init__(self, cfg: GraphSLAMConfig = GraphSLAMConfig(),
                 sensor_in_robot=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.cue_extrinsics is not None:
            # the MULTI assembly: ``process`` takes cue-stacked measurements
            # [C, N, ...]; only the tracker sees them
            self.tracker = tracker_mod.MultiCueTracker(cfg.tracker, cfg.cue_extrinsics,
                                                       device=self.device)
        elif cfg.use_fast_tracker:
            self.tracker = fast_mod.FastTracker(frame_spec(cfg), sensor_in_robot,
                                                device=self.device)
        else:
            self.tracker = tracker_mod.LaserTracker(cfg.tracker, sensor_in_robot,
                                                    device=self.device)
        self._poses_host = np.zeros((0, 3), np.float32)
        self._fixed_host: list[bool] = []
        self._edges_host: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        self.scenes: list[Cloud | None] = []   # one scene per local map (its frame)
        self.adjacency: list[set[int]] = []
        self.n_maps = 0
        self.n_edges = 0
        self.current_map = -1
        # seconds per phase of the loop (``_span``); the validator adds its
        # partition solves under "vote.solve"
        self.phase_times: dict[str, float] = {}
        self.detector = lc.BruteForceLoopDetector(cfg.detector, cfg.tracker.projection)
        self.validator = lc.ClosureValidator(cfg.validator, cfg.closure_edge_info,
                                             device=self.device, times=self.phase_times)
        self.num_closures = 0
        self.relocalizations = 0

    def _span(self, name: str, phase: bool = True):
        """The span ``slam.<name>``, its seconds added to ``phase_times[name]``.
        While tracing, a phase ends in a synchronise on the card, so that
        its seconds hold the work it queued; a child span (``phase``
        False) never synchronises."""
        return profiling.timed(f"slam.{name}", self.device if phase else None,
                               self.phase_times, name)

    # ---- graph bookkeeping (host) -------------------------------------------
    def _add_variable(self, pose: np.ndarray, fixed: bool = False) -> int:
        idx = self.n_maps
        self._poses_host = np.concatenate(
            [self._poses_host, np.asarray(pose, np.float32)[None]])
        self._fixed_host.append(bool(fixed))
        self.adjacency.append(set())
        self.n_maps += 1
        return idx

    def _add_edge(self, i: int, j: int, meas, info) -> None:
        self._edges_host.append(
            (i, j, np.asarray(meas, np.float32), np.asarray(info, np.float32)))
        self.adjacency[i].add(j)
        self.adjacency[j].add(i)
        self.n_edges += 1

    @property
    def poses_np(self) -> np.ndarray:
        return self._poses_host

    @property
    def graph(self) -> pgo.PoseGraph:
        """The pose graph on the device, at power-of-two capacities."""
        nv, ne = self.n_maps, self.n_edges
        vc, ec = pgo.round_capacity(nv), pgo.round_capacity(max(ne, 1))
        poses = np.zeros((vc, 3), np.float32)
        poses[:nv] = self.poses_np
        var_fixed = np.zeros(vc, bool)
        var_fixed[:nv] = self._fixed_host
        ei, ej = np.zeros(ec, np.int64), np.zeros(ec, np.int64)
        meas = np.zeros((ec, 3), np.float32)
        info = np.ones((ec, 3), np.float32)
        evalid = np.zeros(ec, bool)
        for k, (i, j, m, w) in enumerate(self._edges_host):
            ei[k], ej[k], meas[k], info[k], evalid[k] = i, j, m, w, True
        return pgo.graph_from_numpy(poses, np.arange(vc) < nv, var_fixed, ei, ej,
                                    meas, info, evalid, device=self.device)

    def _solve_graph(self) -> pgo.PoseGraph:
        """The global pose-graph solve on ``global_solver_kind``'s solver:
        ``cg`` (matrix-free PCG), ``schur`` (partitioned elimination), any
        other kind the dense solver. Returns the solved graph."""
        graph, _, _ = pgo.trim(self.graph, self.n_maps, self.n_edges)
        kind, gs = self.cfg.global_solver_kind, self.cfg.global_solver
        if kind == "cg":
            solved, _, _ = cg.optimize_cg(
                cg.CGConfig(gn_iterations=gs.max_iterations, epsilon=gs.epsilon,
                            chi_threshold=gs.chi_threshold), graph)
        elif kind == "schur":
            n_parts = min(self.cfg.schur_partitions, max(self.n_maps // 2, 1))
            part = schur.partition_graph(graph, n_parts, n_vars=self.n_maps,
                                         n_edges=self.n_edges)
            solved, _, _ = schur.optimize_schur(gs, graph, part)
        else:
            solved, _, _ = pgo.optimize(gs, graph)
        return solved

    def _global_solve(self) -> None:
        self._poses_host = self._solve_graph().poses[: self.n_maps].cpu().numpy()

    # ---- accessors -----------------------------------------------------------
    def num_variables(self) -> int:
        return self.n_maps

    def num_factors(self) -> int:
        return self.n_edges

    def _robot_in_local_map_np(self) -> np.ndarray:
        """The tracker's pose on the host: the loop's one read per frame."""
        return self.tracker.robot_in_local_map.detach().cpu().numpy().astype(np.float32)

    def robot_in_world(self) -> np.ndarray:
        if self.current_map < 0:
            return np.zeros(3, np.float32)
        return _wrap(lc.compose_np(self._poses_host[self.current_map],
                                   self._robot_in_local_map_np()))

    def scene_of(self, m: int) -> Cloud | None:
        """Scene of local map ``m``: the tracker's live scene for the
        current map, else the scene captured when the map stopped being
        current."""
        if m == self.current_map:
            return self.tracker.capture_scene()
        return self.scenes[m]

    # ---- main entry ----------------------------------------------------------
    def process(self, measurement: Cloud, odom=None) -> None:
        """One message pack: a laser measurement (sensor frame; with
        ``cue_extrinsics`` one per cue, stacked [C, N, ...]) and the
        odometry pose, if any."""
        with self._span("track"):
            if self.current_map < 0:
                self.current_map = self._add_variable(np.zeros(3, np.float32), fixed=True)
                self.scenes.append(None)   # captured when the map stops being current
                self.tracker.compute(measurement, odom)
                return
            self.tracker.compute(measurement, odom)
            # splitting criterion: a new local map after local_map_distance metres
            ril = self._robot_in_local_map_np()
        if float(np.linalg.norm(ril[:2])) >= self.cfg.local_map_distance:
            self._split(measurement, odom, ril)

    def _split(self, measurement: Cloud, odom, ril: np.ndarray) -> None:
        cfg = self.cfg
        # the relocalizer's role is to AVOID new nodes: before splitting, try
        # to re-attach to an existing nearby local map
        with self._span("relocalize"):
            jumped = cfg.enable_relocalizer and self._relocalize_at_split(ril)
        if jumped:
            return
        with self._span("split"):
            prev = self.current_map
            new = self._add_variable(_wrap(lc.compose_np(self._poses_host[prev], ril)))
            self._add_edge(prev, new, ril, cfg.odom_edge_info)
            self.scenes.append(None)
            # the previous map stops being current: capture its final scene, then
            # reseed the tracker on the new local map with this measurement
            self.scenes[prev] = self.tracker.capture_scene()
            self.tracker.reseed(measurement, odom)
            self.scenes[new] = self.tracker.capture_scene()
            self.current_map = new
        if cfg.enable_loop_closure:
            self._loop_closure_round(new)

    def _loop_closure_round(self, query: int) -> None:
        cfg = self.cfg
        with self._span("detect"):
            for c in self.detector.detect(query, self.scenes, self.poses_np, self.n_maps,
                                          self.adjacency):
                self.validator.add(c)
        with self._span("vote"):
            accepted = self.validator.vote(self.poses_np, self.adjacency,
                                           list(self._edges_host))
        added = 0
        with self._span("merge"):
            for c in accepted:
                # one closure edge per map pair: later passes over the same area
                # detect the same closure again at every split
                if c.candidate_map in self.adjacency[c.query_map]:
                    continue
                self._add_edge(c.candidate_map, c.query_map, c.estimate,
                               cfg.closure_edge_info)
                self.num_closures += 1
                added += 1
                if cfg.enable_closure_merger:
                    self._merge_closure_scenes(c)
        if not added:
            return
        with self._span("solve"):
            self._global_solve()
        if cfg.enable_relocalizer:
            with self._span("relocalize"):
                self._try_relocalize()

    def _merge_closure_scenes(self, c: lc.ClosureCandidate) -> None:
        """Fuse the query map's scene into the candidate map's on an
        accepted closure, so later passes track against the joint map."""
        cfg = self.cfg
        fixed, moving = self.scene_of(c.candidate_map), self.scene_of(c.query_map)
        if fixed is None or moving is None:
            return
        est = torch.from_numpy(np.asarray(c.estimate, np.float32)).to(self.device)
        fused = lc.merge_closure_scenes(
            cfg.tracker.projection, fixed.map(lambda x: x[None]),
            moving.map(lambda x: x[None]), est[None],
            point_distance=cfg.detector.aligner.point_distance,
            normal_cos=cfg.detector.aligner.normal_cos,
            max_distance2=cfg.closure_merge_max_distance2,
            target_merges=cfg.closure_merge_target,
            binning=cfg.closure_merge_binning).map(lambda x: x[0])
        if c.candidate_map == self.current_map:
            self.tracker.set_scene(fused,
                                   robot_in_local_map=self.tracker.robot_in_local_map)
        else:
            self.scenes[c.candidate_map] = fused

    def _relocalize_at_split(self, ril: np.ndarray) -> bool:
        """Try to continue on an existing map instead of splitting: the
        nearest older map within the jump radius, verified by an alignment
        that must pass the relocalizer's gates."""
        rcfg = self.cfg.relocalizer
        poses = self.poses_np
        cur_w = _wrap(lc.compose_np(poses[self.current_map], ril))
        cands = []
        for m in range(self.n_maps):
            if m == self.current_map or self.scenes[m] is None:
                continue
            d = float(np.linalg.norm(poses[m, :2] - cur_w[:2]))
            if d <= rcfg.max_translation:
                cands.append((d, m))
        if not cands:
            return False
        best = min(cands)[1]
        # pose of the CURRENT local-map frame in the candidate's frame (the
        # tracker's scene lives in the current map's frame)
        lm_in_best = _wrap(lc.relative_np(poses[best], poses[self.current_map]))
        cur_scene = self.tracker.capture_scene()
        res = lc._batch_align(
            self.detector.cfg.aligner, self.detector.proj,
            self.scenes[best].map(lambda x: x[None]), cur_scene,
            torch.from_numpy(lm_in_best[None]).to(self.device))
        packed = torch.cat([res.num_inliers.to(torch.float32),
                            res.num_correspondences.to(torch.float32),
                            res.chi_inliers, res.estimate[0]]).cpu().numpy()
        n_inl, n_cor, chi_inl = int(packed[0]), max(int(packed[1]), 1), float(packed[2])
        if (n_inl < rcfg.relocalize_min_inliers
                or n_inl / n_cor < rcfg.relocalize_min_inliers_ratio
                or chi_inl > rcfg.relocalize_max_chi_inliers):
            return False
        # jump: the robot in the candidate map through the verified alignment
        new_ril = _wrap(lc.compose_np(packed[3:6], ril))
        if float(np.linalg.norm(new_ril[:2])) >= self.cfg.local_map_distance:
            return False   # would split again at once: not a useful jump
        self.scenes[self.current_map] = cur_scene
        self.tracker.set_scene(self.scenes[best], robot_in_local_map=new_ril)
        self.current_map = best
        self.relocalizations += 1
        return True

    def _try_relocalize(self) -> None:
        """After an accepted closure, continue on the nearest adjacent older
        map within ``max_translation`` instead of growing the graph."""
        rcfg = self.cfg.relocalizer
        poses = self.poses_np
        cur_w = self.robot_in_world()
        best, best_d = -1, rcfg.max_translation
        for m in range(self.n_maps):
            if m == self.current_map:
                continue
            d = float(np.linalg.norm(poses[m, :2] - cur_w[:2]))
            if d < best_d and m in self.adjacency[self.current_map]:
                best, best_d = m, d
        if best < 0:
            return
        ril = _wrap(lc.relative_np(poses[best], cur_w))
        self.scenes[self.current_map] = self.tracker.capture_scene()
        self.tracker.set_scene(self.scenes[best], robot_in_local_map=ril)
        self.current_map = best
        self.relocalizations += 1
