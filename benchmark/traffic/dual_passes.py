"""Offline mapping of one two-laser log: whole passes over a recorded MULTI
log through the port's per-message loop (``models/runner.SlamRunner`` with
``scan_topics``, fed by ``io/sources.SynchronizedSource``), back to back,
each through a fresh runner, as fast as the program goes.

The traffic (a ``traffic/<mix>.json`` of ``"generator": "dual_passes"``):
the log and its ground truth (files of the repository, held to their
SHA-256), parsed in set-up; ``copies`` copies of it with N(0,
``noise_sigma``) metres added to every range, drawn from the run's seed in
set-up and cycled. The warm-up runs the first ``warm_packs`` packs of the
last copy (a split, a closure round, a solve and a relocalization among
them, which it logs); ``max_packs`` cuts every pass short (None: the whole
log).

End-to-end: ``map_frames_per_s``, every pack that ``put_message``
processed inside the window (it reads the pose back, so each such frame is
complete) over the time from the window's start to the last such frame's
return. The window ends at the first frame past its length once a pass is
complete.

The check: every completed pass's trajectory against the ground truth
(``ate_rmse_m``), its closures (``passes_without_closures``) and kernel 6's
launches against its tracked frames (``launch_gap``; on the CPU, where the
plain version launches nothing, the aligner's calls). One completed pass
drawn from the seed is captured: every call of kernel 6 replayed on its
inputs through ``reference/multicue.align_multi``
(``cue_estimate_off_share``: estimates off by more than 1e-3;
``cue_estimate_gap``: the largest difference), ``frames_checked``
consecutive multi-cue steps drawn from the seed, each from the program's
state before it, through ``reference/multicue.step``
(``multi_scene_off_share``: scene rows whose validity differs or whose
point or normal is off by more than 1e-3, over the rows live on either
side), and every global solve against ``reference/pgo.py``
(``solve_chi_excess``, ``solve_pose_gap_m``).
"""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..reference import ate, multicue, prep
from ..reference.precision import computed_in
from .log_passes import EST_TOL, LogRun, _finite_max, _sha256

ROOT = Path(__file__).resolve().parent.parent.parent


def reference_settings(config: dict) -> dict:
    """What the references need, read from the configuration file itself."""
    by_id = {o["#id"]: o for o in config["objects"]}
    named = {name: by_id[i] for name, i in config["names"].items()}
    slam = named["slam"]
    trk = by_id[slam["tracker"]["#pointer"]]
    al = by_id[trk["aligner"]["#pointer"]]
    gs = by_id[slam["global_solver"]["#pointer"]]
    p = trk["projection"]["values"]
    return {
        "proj": prep.PolarProjection(p["cols"], p["angle_min"], p["angle_max"], p["range_min"],
                                     p["range_max"], p["f"], p["c"]),
        "aligner": dict(iterations=al["max_iterations"], point_distance=al["point_distance"],
                        normal_cos=al["normal_cos"], chi_threshold=al["chi_threshold"],
                        min_inliers=al["min_num_inliers"],
                        min_corr=al["min_num_correspondences"], odom_weight=al["odom_weight"],
                        damping=al["damping"]),
        "merge_threshold": trk["merge_threshold"],
        "cues": len(slam["cue_extrinsics"]),
        "pgo": {k: gs[k] for k in ("max_iterations", "epsilon", "chi_threshold", "damping",
                                   "anchor_weight")},
        "algorithm": gs["algorithm"],
        "solver": slam["global_solver_kind"],
    }


def _counters() -> dict:
    """The program's counters of kernel 6 and of the multi-cue step (None
    where the program has no such counter)."""
    from srrg2_laser_slam_2d_tpu_torch.models import tracker
    from srrg2_laser_slam_2d_tpu_torch.ops import multicue_align_kernel as mak

    return {"launches": getattr(mak, "launches", None),
            "moving_rows": getattr(mak, "moving_rows", None),
            "fixed_rows": getattr(mak, "fixed_rows", None),
            "multi_frames": getattr(tracker, "multi_frames", None)}


class Capture:
    """The kept pass's calls: kernel 6's inputs and estimate, each
    multi-cue step's inputs and the state it returned, each global solve's
    graph and poses. The tracker replaces its state and never writes it in
    place, so the steps are kept by reference."""

    def __init__(self):
        self.aligns, self.steps, self.solves = [], [], []


class Hooks:
    """Wrap kernel 6's entry, the multi-cue step and the solve for the run;
    a solve is recorded only inside ``GraphSLAM2D._solve_graph`` (the
    global solve, not the validator's partitions)."""

    def __init__(self):
        from srrg2_laser_slam_2d_tpu_torch.models import slam as slam_mod
        from srrg2_laser_slam_2d_tpu_torch.models import tracker
        from srrg2_laser_slam_2d_tpu_torch.ops import multicue_align_kernel as mak
        from srrg2_laser_slam_2d_tpu_torch.solver import pgo as port_pgo

        self.capture: Capture | None = None
        self.calls = 0          # kernel 6's entry, every call of the run
        self._global = False
        align, step = mak.fused_projective_align_multi, tracker.track_step_multi
        solve, solve_graph = port_pgo.optimize, slam_mod.GraphSLAM2D._solve_graph

        def align_hook(proj, *args, **kw):
            out = align(proj, *args, **kw)
            self.calls += 1
            if self.capture is not None:
                self.capture.aligns.append((args[:8], kw.get("odom_prior"), out[0]))
            return out

        def step_hook(cfg, state, measurements, extrinsics, odom, odom_valid, *a, **kw):
            out = step(cfg, state, measurements, extrinsics, odom, odom_valid, *a, **kw)
            if self.capture is not None:
                self.capture.steps.append((state, measurements, extrinsics, odom, odom_valid,
                                           out[0]))
            return out

        def solve_hook(cfg, graph, *a, **kw):
            if self.capture is None or not self._global:
                return solve(cfg, graph, *a, **kw)
            held = graph._replace(**{f: getattr(graph, f).clone() for f in graph._fields})
            out = solve(cfg, graph, *a, **kw)
            self.capture.solves.append((held, out[0].poses))
            return out

        def solve_graph_hook(slam_self):
            self._global = True
            try:
                return solve_graph(slam_self)
            finally:
                self._global = False

        self._originals = [(mak, "fused_projective_align_multi", align),
                           (tracker, "track_step_multi", step),
                           (port_pgo, "optimize", solve),
                           (slam_mod.GraphSLAM2D, "_solve_graph", solve_graph)]
        mak.fused_projective_align_multi = align_hook
        tracker.track_step_multi = step_hook
        port_pgo.optimize = solve_hook
        slam_mod.GraphSLAM2D._solve_graph = solve_graph_hook

    def remove(self) -> None:
        for owner, name, fn in self._originals:
            setattr(owner, name, fn)


class DualRun:
    """One run of a two-laser log cell."""

    def __init__(self, config: dict, config_path: Path, mix: dict, cell: dict, seed: int,
                 device):
        from srrg2_laser_slam_2d_tpu_torch.io.messages import LaserMessage
        from srrg2_laser_slam_2d_tpu_torch.io.sources import JsonlFileSource
        from srrg2_laser_slam_2d_tpu_torch.utils import config as config_mod

        self.device, self.cell, self.mix = device, cell, mix
        self.limits = cell["limits"]
        for key in ("log", "ground_truth"):
            if _sha256(ROOT / mix[key]) != mix["sha256"][key]:
                raise RuntimeError(f"{mix[key]} is not the file the benchmark was written for")
        mgr = config_mod.ConfigManager.read(str(config_path))
        self.slam_cfg, self.pre_cfg = mgr.get_by_name("slam"), mgr.get_by_name("preprocessor")
        self.runner_kw = config["runner"]
        self.ref = reference_settings(config)
        if self.ref["solver"] != "dense" or self.ref["algorithm"] != "gn":
            raise ValueError("the solve's reference is the dense Gauss-Newton solve")
        self.info = {"cues": self.ref["cues"], "iterations": self.ref["aligner"]["iterations"]}
        msgs = list(JsonlFileSource(str(ROOT / mix["log"])))
        self.gt = ate.read_tum(ROOT / mix["ground_truth"])
        # the copies' noise is drawn from the run's seed
        rng = np.random.default_rng([seed, 4])
        self.copies = []
        for _ in range(mix["copies"]):
            out = []
            for m in msgs:
                if isinstance(m, LaserMessage):
                    m = copy.copy(m)
                    r = np.asarray(m.ranges, np.float32)
                    m.ranges = (r + rng.normal(0.0, mix["noise_sigma"], r.shape)).astype(np.float32)
                out.append(m)
            self.copies.append(out)
        self.hooks = Hooks()
        self.pick = np.random.default_rng([seed, 2])
        self.passes: list[dict] = []
        self.kept = None
        self.frames_done = 0
        self.counters: dict = {}

    # ------------------------------------------------------------ a pass
    def _packs(self, msgs):
        from srrg2_laser_slam_2d_tpu_torch.io.sources import ListSource, SynchronizedSource

        kw = self.runner_kw
        return SynchronizedSource(ListSource(msgs), kw["sync_topics"],
                                  time_interval=kw["sync_interval"])

    def _pass(self, msgs, t_end: float | None, capture: bool, max_packs: int | None):
        """One pass through a fresh runner; once ``t_end`` has passed and a
        pass is complete, stops after the frame in hand. Returns (record or
        None if cut, frames processed, the time the last of them returned)."""
        from srrg2_laser_slam_2d_tpu_torch.models.runner import SlamRunner
        from srrg2_laser_slam_2d_tpu_torch.ops import multicue_align_kernel as mak

        kw = self.runner_kw
        runner = SlamRunner(slam_config=self.slam_cfg, preprocessor_config=self.pre_cfg,
                            scan_topics=list(kw["scan_topics"]),
                            sensor_frames=list(kw["sensor_frames"]),
                            base_frame=kw["base_frame"], odom_topic=kw["odom_topic"],
                            device=self.device)
        cap = Capture() if capture else None
        self.hooks.capture = cap
        launches0, calls0 = mak.launches, self.hooks.calls
        frames = packs = 0
        last = time.perf_counter()
        try:
            for pack in self._packs(msgs):
                if max_packs is not None and packs >= max_packs:
                    break
                packs += 1
                if runner.put_message(pack):
                    frames, last = frames + 1, time.perf_counter()
                    if t_end is not None and last >= t_end and self.passes:
                        return None, frames, last
        finally:
            self.hooks.capture = None
        slam = runner.slam
        on_card = torch.device(self.device).type == "cuda"
        rec = {"trajectory": [(t, np.asarray(p, np.float64)) for t, p, _ in runner.trajectory],
               "variables": slam.num_variables(), "factors": slam.num_factors(),
               "closures": slam.num_closures, "relocalizations": slam.relocalizations,
               "phases": dict(slam.phase_times), "frames": frames,
               "tracked": slam.tracker.steps,
               "launches": (mak.launches - launches0) if on_card else self.hooks.calls - calls0,
               "capture": cap}
        return rec, frames, last

    def warm_up(self) -> None:
        n = self.mix["warm_packs"]
        if self.mix.get("max_packs") is not None:
            n = min(n, self.mix["max_packs"])
        rec, frames, _ = self._pass(self.copies[-1], None, capture=False, max_packs=n)
        ph = rec["phases"]
        print(f"[dual_passes] warm-up: {frames} frames, {rec['variables']} maps, "
              f"{rec['closures']} closures, {rec['relocalizations']} relocalizations; phases "
              + ", ".join(f"{k} {ph[k]:.3f} s" for k in sorted(ph)), file=sys.stderr, flush=True)

    def run_window(self, seconds: float, spans=None) -> dict:
        self.counters["start"] = _counters()
        t_start = time.perf_counter()
        t_end = t_start + seconds
        last = t_start
        i = 0
        while last < t_end or not self.passes:
            msgs = self.copies[i % len(self.copies)]
            # one completed pass, drawn from the seed (reservoir sampling); the
            # draw is made before the pass, so that only the pass kept is captured
            keep = self.pick.random() * (len(self.passes) + 1) < 1.0
            t0 = time.perf_counter()
            rec, frames, last = self._pass(msgs, t_end, capture=keep,
                                           max_packs=self.mix.get("max_packs"))
            self.frames_done += frames
            if rec is not None:
                rec["seconds"] = last - t0
                self.passes.append(rec)
                if keep:
                    self.kept = rec
            i += 1
        self.counters["end"] = _counters()
        window = last - t_start
        secs = sorted(p["seconds"] for p in self.passes)
        print(f"[dual_passes] {len(secs)} passes and {self.frames_done} frames in {window:.3f} s; "
              f"s a pass: min {secs[0]:.3f} max {secs[-1]:.3f}; closures a pass "
              f"{[p['closures'] for p in self.passes]}", file=sys.stderr, flush=True)
        return {"map_frames_per_s": self.frames_done / window}

    def attempted(self) -> int:
        return len(self.passes)

    def failed(self) -> int:
        return sum(1 for p in self.passes if p["closures"] == 0)

    def release(self) -> None:
        self.hooks.remove()

    # ------------------------------------------------------------ check
    def check(self, control_dtype=None) -> list[tuple[str, float, float]]:
        lim = self.limits
        ate_worst = max(ate.statistics(p["trajectory"], *self.gt)["ate_rmse_m"]
                        for p in self.passes)
        out = [("ate_rmse_m", ate_worst, float(lim["ate_rmse_m"])),
               ("passes_without_closures", float(self.failed()),
                float(lim["passes_without_closures"])),
               ("launch_gap", float(max(abs(p["launches"] - p["tracked"]) for p in self.passes)),
                float(lim["launch_gap"]))]
        cap = None if self.kept is None else self.kept["capture"]
        # a pass aligns and steps every tracked frame, and one that closed
        # loops solved: a capture without them means the hooks no longer see
        # the calls
        if (cap is None or not cap.aligns or not cap.steps
                or (self.kept["closures"] > 0 and not cap.solves)):
            return out + [("unchecked", 1.0, 0.0)]
        nums = {}
        nums.update(self._check_aligns(cap, control_dtype))
        nums.update(self._check_steps(cap, control_dtype))
        nums.update(LogRun._check_solves(self, cap, control_dtype))
        return out + [(k, v, float(lim[k])) for k, v in nums.items()]

    def _check_aligns(self, cap, dtype) -> dict:
        """Every kernel 6 call of the pass on its own inputs, replayed as one
        batch (the calls' shapes and extrinsics are the same)."""
        r = self.ref
        args = [torch.stack(xs) for xs in zip(*(a for a, _, _ in cap.aligns))]
        extr = args.pop(3)[0]
        prior = torch.stack([p for _, p, _ in cap.aligns])
        got = torch.stack([e for _, _, e in cap.aligns])
        with computed_in(None):
            ref = multicue.align_multi(r["proj"], *args[:3], extr, *args[3:], odom_prior=prior,
                                       **r["aligner"]).estimate
        if dtype is not None:
            with computed_in(dtype):
                a = _cast(args, dtype)
                got = multicue.align_multi(r["proj"], *a[:3], extr.to(dtype), *a[3:],
                                           odom_prior=prior.to(dtype),
                                           **r["aligner"]).estimate.float()
        d = (got - ref).abs()
        d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf"))).amax(-1)
        return {"cue_estimate_off_share": float((d > EST_TOL).sum()) / d.shape[0],
                "cue_estimate_gap": _finite_max(d)}

    def _check_steps(self, cap, dtype) -> dict:
        """``frames_checked`` consecutive steps drawn from the seed, each from
        the program's state before it, against the reference's step."""
        r = self.ref
        n = min(int(self.cell["frames_checked"]), len(cap.steps))
        lo = int(self.pick.integers(len(cap.steps) - n + 1))
        off = live = 0
        for state, meas, extr, odom, odom_valid, new in cap.steps[lo:lo + n]:
            ref_state = multicue.State(prep.Cloud(*state.scene), state.robot_in_local_map,
                                       state.last_odom, state.has_odom)
            with computed_in(None):
                want, _ = multicue.step(r["proj"], r["aligner"], r["merge_threshold"],
                                        ref_state, prep.Cloud(*meas), extr, odom, odom_valid)
            got = prep.Cloud(*new.scene)
            if dtype is not None:
                with computed_in(dtype):
                    s = multicue.State(prep.Cloud(*_cast(state.scene, dtype)),
                                       *_cast((state.robot_in_local_map, state.last_odom,
                                               state.has_odom), dtype))
                    got, _ = multicue.step(r["proj"], r["aligner"], r["merge_threshold"], s,
                                           prep.Cloud(*_cast(meas, dtype)),
                                           *_cast((extr, odom, odom_valid), dtype))
                got = got.map(lambda x: x.float() if x.is_floating_point() else x)
            rows = got.valid | want.valid
            d = torch.cat([got.xy - want.xy, got.normal - want.normal], -1).abs().amax(-1)
            bad = rows & ((got.valid != want.valid) | ~(d <= EST_TOL))
            off += int(bad.sum())
            live += int(rows.sum())
        return {"multi_scene_off_share": off / max(live, 1)}


def _cast(xs, dtype):
    return tuple(x.to(dtype) if x.is_floating_point() else x for x in xs)


def setup(cell, seed: int, device) -> DualRun:
    return DualRun(cell.config, cell.config_path, cell.mix, cell.limits, seed, device)
