"""Offline mapping of one log: whole passes over a recorded log through the
port's chunked SLAM loop (``models/chunked_slam.ChunkedSlamRunner``:
``put_message`` / ``finish``), back to back, each through a fresh runner.

The traffic (a ``traffic/<mix>.json`` of ``"generator": "log_passes"``): the
log and its ground truth (files of the repository, held to their SHA-256),
parsed in set-up; ``copies`` copies of it with N(0, ``noise_sigma``) metres
added to every range (as the port's ``bench/corridor_e2e.perturbed`` does),
drawn from the run's seed in set-up and cycled, so the window times the
program alone. The warm-up pass runs the last copy.

End-to-end: ``map_frames_per_s``, every frame of every chunk completed in
the window over the time from the window's start to the last chunk's end.

The check: every completed pass's trajectory against the ground truth, by
the gate's own limits (the port's ``CORRIDOR_THRESHOLDS``, closures
accepted); and for one completed pass drawn from the seed (only that pass
is captured), in one of its chunks (drawn from the seed) kernel 1's first
``frames_checked`` frames from the program's state at the chunk's start and
as many after a local-map split drawn from the seed anywhere in the chunk,
from the state that split hands on; every NN-ICP launch of the pass on the
pairs the program chose, and every pose-graph solve of the pass on the
graph the program built, each against its reference.
"""

from __future__ import annotations

import copy
import hashlib
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..reference import ate, frame, nn_icp, pgo, prep
from ..reference.precision import computed_in
from ..reference.stream import Spec

ROOT = Path(__file__).resolve().parent.parent.parent
# an estimate counts as off beyond this (metres / radians)
EST_TOL = 1e-3


def _objects(config: dict) -> dict:
    """The configuration's objects by name (the port's object-graph JSON)."""
    by_id = {o["#id"]: o for o in config["objects"]}
    return {name: by_id[i] for name, i in config["names"].items()}, by_id


def reference_settings(config: dict) -> dict:
    """What the references need, read from the configuration file itself."""
    named, by_id = _objects(config)
    slam = named["slam"]
    trk = by_id[slam["tracker"]["#pointer"]]
    al = by_id[trk["aligner"]["#pointer"]]
    det = by_id[slam["detector"]["#pointer"]]
    dal = by_id[det["aligner"]["#pointer"]]
    gs = by_id[slam["global_solver"]["#pointer"]]
    p = trk["projection"]["values"]
    fs = config["frame_spec_defaults"]
    spec = Spec(projection=prep.PolarProjection(p["cols"], p["angle_min"], p["angle_max"],
                                                p["range_min"], p["range_max"], p["f"], p["c"]),
                scene_capacity=trk["scene_capacity"], iterations=al["max_iterations"],
                point_distance=al["point_distance"], normal_cos=al["normal_cos"],
                chi_threshold=al["chi_threshold"], min_inliers=al["min_num_inliers"],
                odom_weight=al["odom_weight"], merge_threshold=trk["merge_threshold"],
                merge_shift=fs["merge_shift"], window=fs["window"], stream_gather="onehot",
                stream_band_shift=64, corr_refresh=1, split_distance=slam["local_map_distance"])
    return {
        "spec": spec,
        "pre": named["preprocessor"],
        "nn": dict(iterations=dal["max_iterations"], max_distance=dal["point_distance"],
                   normal_cos=dal["normal_cos"], chi_threshold=dal["chi_threshold"],
                   min_inliers=dal["min_num_inliers"], corr_refresh=det["fused_corr_refresh"]),
        "gate": dict(min_inliers=det["relocalize_min_inliers"],
                     min_ratio=det["relocalize_min_inliers_ratio"],
                     max_chi=det["relocalize_max_chi_inliers"]),
        "pgo": {k: gs[k] for k in ("max_iterations", "epsilon", "chi_threshold", "damping",
                                   "anchor_weight")},
        "algorithm": gs["algorithm"],
        "solver": slam["global_solver_kind"],
    }


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


class Capture:
    """The program's calls into kernel 1, kernel 2 and the solve during the
    pass the check keeps: their inputs and outputs, copied only where the
    loop overwrites them later (kernel 1's carried state, the graph)."""

    def __init__(self):
        self.frames, self.pairs, self.solves = [], [], []


class Hooks:
    """Wrap the three entries for the run, each recording into ``capture``."""

    def __init__(self):
        from srrg2_laser_slam_2d_tpu_torch.models import chunked_slam
        from srrg2_laser_slam_2d_tpu_torch.ops import nn_icp_kernel
        from srrg2_laser_slam_2d_tpu_torch.solver import pgo as port_pgo

        self.capture: Capture | None = None
        track, align, solve = (chunked_slam.track_frames_grid,
                               nn_icp_kernel.fused_align_pairs, port_pgo.optimize)

        def track_hook(spec, cacheT, pose, measC):
            if self.capture is not None:
                self.capture.frames.append((cacheT.clone(), pose.clone(), measC))
            out = track(spec, cacheT, pose, measC)
            if self.capture is not None:
                self.capture.frames[-1] += (out,)
            return out

        def align_hook(fixed, moving, initials, **kw):
            out = align(fixed, moving, initials, **kw)
            if self.capture is not None:
                self.capture.pairs.append((fixed, moving, initials, out))
            return out

        def solve_hook(cfg, graph, *a, **kw):
            if self.capture is None:
                return solve(cfg, graph, *a, **kw)
            # the graph's tensors are the loop's buffers, which later edges
            # and poses overwrite: the check needs them as this call saw them
            held = graph._replace(**{f: getattr(graph, f).clone() for f in graph._fields})
            out = solve(cfg, graph, *a, **kw)
            self.capture.solves.append((held, out[0].poses))
            return out

        self._originals = [(chunked_slam, "track_frames_grid", track),
                           (nn_icp_kernel, "fused_align_pairs", align),
                           (port_pgo, "optimize", solve)]
        chunked_slam.track_frames_grid = track_hook
        nn_icp_kernel.fused_align_pairs = align_hook
        port_pgo.optimize = solve_hook

    def remove(self) -> None:
        """Put the three entries back."""
        for mod, name, fn in self._originals:
            setattr(mod, name, fn)


class LogRun:
    """One run of a log cell."""

    def __init__(self, config: dict, config_path: Path, mix: dict, cell: dict, seed: int,
                 device):
        from srrg2_laser_slam_2d_tpu_torch.io.messages import LaserMessage, OdometryMessage
        from srrg2_laser_slam_2d_tpu_torch.io.sources import JsonlFileSource
        from srrg2_laser_slam_2d_tpu_torch.utils import config as config_mod

        self.device, self.cell, self.mix = device, cell, mix
        self.limits = cell["limits"]
        for key in ("log", "ground_truth"):
            path = ROOT / mix[key]
            if _sha256(path) != mix["sha256"][key]:
                raise RuntimeError(f"{mix[key]} is not the file the benchmark was written for")
        mgr = config_mod.ConfigManager.read(str(config_path))
        self.slam_cfg, self.pre_cfg = mgr.get_by_name("slam"), mgr.get_by_name("preprocessor")
        self.chunk = int(config["runner"]["chunk"])
        self.ref = reference_settings(config)
        if self.ref["solver"] != "dense" or self.ref["algorithm"] != "gn":
            raise ValueError("the solve's reference is the dense Gauss-Newton solve")
        msgs = list(JsonlFileSource(str(ROOT / mix["log"])))
        if mix.get("max_frames"):
            lasers = [i for i, m in enumerate(msgs) if isinstance(m, LaserMessage)]
            if len(lasers) > mix["max_frames"]:
                msgs = msgs[: lasers[mix["max_frames"]]]
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
        self.laser_type, self.odom_type = LaserMessage, OdometryMessage
        self.hooks = Hooks()
        self.pick = np.random.default_rng([seed, 2])
        self.passes: list[dict] = []
        self.kept = None
        self.frames_done = 0

    # ------------------------------------------------------------ a pass
    def _pass(self, msgs, t_end: float | None, capture: bool):
        """One pass through a fresh runner; stops at a chunk boundary once
        ``t_end`` has passed. Returns (record or None if cut, frames of the
        completed chunks, the time the last of them ended)."""
        from srrg2_laser_slam_2d_tpu_torch.models.chunked_slam import ChunkedSlamRunner

        runner = ChunkedSlamRunner(slam_config=self.slam_cfg,
                                   preprocessor_config=self.pre_cfg, chunk=self.chunk,
                                   device=self.device)
        cap = Capture() if capture else None
        self.hooks.capture = cap
        frames = lasers = 0
        last = time.perf_counter()
        try:
            for m in msgs:
                # a chunk's frames are processed inside the put_message of its last one
                if runner.put_message(m):
                    lasers += 1
                    if lasers % self.chunk == 0:
                        frames, last = lasers, time.perf_counter()
                        # the window ends at a chunk boundary, once a pass is complete
                        if t_end is not None and last >= t_end and self.passes:
                            return None, frames, last
            runner.finish()
            frames, last = lasers, time.perf_counter()
        finally:
            self.hooks.capture = None
        slam = runner.slam
        rec = {"trajectory": [(t, np.asarray(p, np.float64)) for t, p, _ in runner.trajectory],
               "variables": slam.num_variables(), "factors": slam.num_factors(),
               "closures": slam.num_closures, "phases": dict(slam.phase_times),
               "frames": frames, "msgs": msgs, "capture": cap}
        return rec, frames, last

    def warm_up(self) -> None:
        self._pass(self.copies[-1], None, capture=False)

    def run_window(self, seconds: float, spans=None) -> dict:
        t_start = time.perf_counter()
        t_end = t_start + seconds
        last = t_start
        i = 0
        while last < t_end:
            msgs = self.copies[i % len(self.copies)]
            # one completed pass, drawn from the seed (reservoir sampling); the
            # draw is made before the pass, so that only the pass kept is captured
            keep = self.pick.random() * (len(self.passes) + 1) < 1.0
            t0 = time.perf_counter()
            rec, frames, last = self._pass(msgs, t_end, capture=keep)
            self.frames_done += frames
            if rec is not None:
                rec["seconds"] = last - t0
                self.passes.append(rec)
                if keep:
                    self.kept = rec
            i += 1
        window = last - t_start
        secs = sorted(p["seconds"] for p in self.passes)
        closures = [p["closures"] for p in self.passes]
        print(f"[log_passes] {len(secs)} passes, s a pass: min {secs[0]:.3f} median "
              f"{secs[len(secs) // 2]:.3f} max {secs[-1]:.3f}; closures a pass "
              f"{min(closures)}-{max(closures)}", file=sys.stderr, flush=True)
        return {"map_frames_per_s": self.frames_done / window}

    def attempted(self) -> int:
        return len(self.passes)

    def failed(self) -> int:
        return sum(1 for p in self.passes if p["factors"] < p["variables"])

    def release(self) -> None:
        self.hooks.remove()

    # ------------------------------------------------------------ check
    def check(self, control_dtype=None) -> list[tuple[str, float, float]]:
        lim = self.limits
        out = []
        worst = {k: 0.0 for k in ("ate_mean_x_m", "ate_mean_y_m", "ate_std_x_m", "ate_std_y_m",
                                  "ate_mean_rotation_rad", "ate_std_rotation_rad")}
        no_closure = 0
        for p in self.passes:
            s = ate.statistics(p["trajectory"], *self.gt)
            for k in worst:
                worst[k] = max(worst[k], s[k])
            no_closure += int(p["factors"] < p["variables"])
        out += [(k, v, float(lim[k])) for k, v in worst.items()]
        out.append(("passes_without_closures", float(no_closure),
                    float(lim["passes_without_closures"])))
        cap = None if self.kept is None else self.kept["capture"]
        # a pass tracks frames, and one that closed loops aligned pairs and
        # solved: a capture without them means the hooks no longer see the calls
        if cap is None or not cap.frames or (self.kept["closures"] > 0
                                             and not (cap.pairs and cap.solves)):
            return out + [("unchecked", 1.0, 0.0)]
        nums = {}
        nums.update(self._check_frames(cap, self.kept["msgs"], control_dtype))
        nums.update(self._check_pairs(cap, control_dtype))
        nums.update(self._check_solves(cap, control_dtype))
        return out + [(k, v, float(lim[k])) for k, v in nums.items()]

    def _chunk_canvases(self, msgs, c: int, lo: int, n: int) -> torch.Tensor:
        """Chunk ``c``'s canvases ``lo`` to ``lo + n`` (fewer at the chunk's
        end) as the reference works them out from the pass's ranges and
        odometry."""
        ranges, odoms, model = self._log(msgs)
        first = next(o for o in odoms if o is not None)
        filled, prev = [], first
        for o in odoms:
            prev = o if o is not None else prev
            filled.append(prev)
        # the chunk's frames; the first chunk's grid starts at frame 1 (frame 0 seeds)
        lo += c * self.chunk + (1 if c == 0 else 0)
        idx = list(range(lo, min(lo + n, (c + 1) * self.chunk, len(ranges))))
        scan = prep.PolarProjection.make(
            len(model.ranges), float(model.angle_min), float(model.angle_max),
            max(float(model.range_min), self.ref["pre"]["range_min"]),
            min(float(model.range_max), self.ref["pre"]["range_max"]))
        spec = self.ref["spec"]
        r = torch.from_numpy(np.stack([ranges[i] for i in idx])).to(self.device)
        clouds = prep.preprocess(scan, self.ref["pre"], r)
        canv = prep.measurement_canvas(spec.projection, spec.cols_padded, clouds)
        canv[:, 6, 0:3] = torch.from_numpy(np.stack([filled[i] for i in idx])).to(canv)
        canv[:, 6, 3] = 1.0
        return canv

    def _log(self, msgs):
        """The pass's ranges, the odometry before each scan (None before the
        first), and the last scan message."""
        ranges, odoms, model, last = [], [], None, None
        for m in msgs:
            if isinstance(m, self.odom_type):
                last = np.asarray(m.pose, np.float32)
            elif isinstance(m, self.laser_type):
                model = m
                ranges.append(np.asarray(m.ranges, np.float32))
                odoms.append(last)
        return ranges, odoms, model

    def _chunk_frames(self, msgs, c: int) -> int:
        """The live frames of chunk ``c``'s grid (the rest is padding)."""
        total = len(self._log(msgs)[0])
        lo = c * self.chunk + (1 if c == 0 else 0)
        return max(0, min((c + 1) * self.chunk, total) - lo)

    def _check_frames(self, cap, msgs, dtype) -> dict:
        """Kernel 1 over two windows of a chunk drawn from the seed: its
        first frames from the program's state at the chunk's start, and the
        frames after a split drawn from the seed, from the state that split
        hands on (``split_state``)."""
        n = int(self.cell["frames_checked"])
        c = int(self.pick.integers(len(cap.frames)))
        cacheT, pose, measC, (_, _, payloads) = cap.frames[c]
        windows = [(0, cacheT, pose)]
        splits = self.splits(msgs, c, payloads)
        if splits:
            s = splits[int(self.pick.integers(len(splits)))]
            windows.append((s + 1,) + self.split_state(msgs, c, s, cacheT, pose, payloads))
        nums = [self._check_window(measC, payloads, msgs, c, lo, n, c_in, p_in, dtype)
                for lo, c_in, p_in in windows]
        return {k: max(v[k] for v in nums) for k in nums[0]}

    def splits(self, msgs, c: int, payloads) -> list[int]:
        """The frames of chunk ``c``'s grid where the program split its local
        map, each with a live frame after it."""
        live = self._chunk_frames(msgs, c)
        return (payloads[: live - 1, 6, 7] > 0).nonzero().flatten().tolist()

    def split_state(self, msgs, c: int, s: int, cacheT, pose, payloads):
        """The kernel's state after a split at frame ``s`` of chunk ``c``: a
        split seeds the new local map with the frame's own canvas (the
        reference's), the program's seed mask, slots and point count, the
        pose at the origin and the frame's odometry."""
        pay = payloads[s]
        with computed_in(None):
            canv = self._chunk_canvases(msgs, c, s, 1)[0]
        cache = torch.zeros_like(cacheT)
        cache[0:4] = canv[1:5]
        cache[4] = (pay[5] == 2).to(cache)
        cache[5] = pay[4]
        p = pose.clone()
        p[0, 0:3] = 0.0
        p[0, 3:6] = canv[6, 0:3]
        p[0, 6] = 1.0
        p[0, 7] = pay[6, 11]
        return cache, p

    def _check_window(self, measC, payloads, msgs, c, lo, n, cacheT, pose, dtype) -> dict:
        """Frames ``lo`` to ``lo + n`` of chunk ``c`` (fewer at its end) from
        the state ``cacheT``, ``pose`` against the program's canvases and
        payloads."""
        spec = self.ref["spec"]
        with computed_in(None):
            mine = self._chunk_canvases(msgs, c, lo, n)
            n = mine.shape[0]
            _, _, ref_pay = frame.track_frames(spec, cacheT, pose, mine)
        got_canvas, got = measC[lo:lo + n], payloads[lo:lo + n]
        if dtype is not None:
            # the control: the reference in ``dtype`` in the program's place,
            # canvases and frame step
            with computed_in(dtype):
                got_canvas = self._chunk_canvases(msgs, c, lo, n)
                _, _, got = frame.track_frames(spec, cacheT.to(dtype), pose.to(dtype),
                                               got_canvas)
            got_canvas, got = got_canvas.float(), got.float()
        live = (got_canvas[:, 5] > 0) | (mine[:, 5] > 0)
        dif = (got_canvas[:, :6] - mine[:, :6]).abs().amax(1)
        canvas_off = live & (((got_canvas[:, 5] > 0) != (mine[:, 5] > 0)) | (dif > EST_TOL))
        est = torch.cat([(got[:, 6, 0:3] - ref_pay[:, 6, 0:3]).abs(),
                         (got[:, 6, 8:11] - ref_pay[:, 6, 8:11]).abs()], -1)
        lv = (got[:, 5] > 0) | (ref_pay[:, 5] > 0)
        dec = lv & ((got[:, 5] != ref_pay[:, 5]) | (got[:, 4] != ref_pay[:, 4]))
        return {"canvas_off_share": float(canvas_off.sum()) / max(float(live.sum()), 1.0),
                "frame_estimate_gap": _finite_max(est),
                "frame_decision_off_share": float(dec.sum()) / max(float(lv.sum()), 1.0)}

    def _check_pairs(self, cap, dtype) -> dict:
        n = off = 0
        for fixed, moving, initials, res in cap.pairs:
            with computed_in(None):
                ref = nn_icp.align_pairs(prep.Cloud(*fixed), prep.Cloud(*moving), initials,
                                         **self.ref["nn"])
            if dtype is not None:
                def cast(x):
                    return x.to(dtype) if x.is_floating_point() else x

                with computed_in(dtype):
                    got = nn_icp.align_pairs(prep.Cloud(*(cast(x) for x in fixed)),
                                             prep.Cloud(*(cast(x) for x in moving)),
                                             cast(initials), **self.ref["nn"])[0].float()
            else:
                got = res.estimate
            d = (got - ref[0]).abs()
            d = torch.where(torch.isfinite(d), d, torch.full_like(d, math.inf)).amax(-1)
            off += int((d > EST_TOL).sum())
            n += d.shape[0]
        return {"closure_estimate_off_share": off / max(n, 1)}

    def _check_solves(self, cap, dtype) -> dict:
        """Each solve against the float64 reference's solution of the same
        graph: the excess of the objective the program's poses reach,
        relative, and the widest gap of the live poses' positions. The
        card's atomic sums make the program's solve land in another of the
        robust objective's minima now and then (two runs of the same graph
        differ by some decimetres), so the pose gap is held to a limit that
        tells such a minimum from a solve that went wrong."""
        excess = gap = 0.0
        for graph, solved in cap.solves:
            args = (graph.poses, graph.var_valid, graph.var_fixed, graph.edge_i, graph.edge_j,
                    graph.edge_meas, graph.edge_info, graph.edge_valid)
            with computed_in(torch.float64):
                a64 = [a.double() if a.is_floating_point() else a for a in args]
                ref = pgo.optimize(self.ref["pgo"], *a64)
                if dtype is not None:
                    with computed_in(dtype):
                        solved = pgo.optimize(self.ref["pgo"], *(
                            a.to(dtype) if a.is_floating_point() else a for a in args))
                g = pgo._Graph(*a64)
                chi_ref = float(pgo.graph_chi(g, ref))
                chi_got = float(pgo.graph_chi(g, solved.double()))
                d = (solved.double() - ref)[graph.var_valid, 0:2].abs()
            rel = (chi_got - chi_ref) / max(chi_ref, 1.0)
            excess = max(excess, rel if math.isfinite(rel) else math.inf)
            gap = max(gap, _finite_max(d))
        return {"solve_chi_excess": excess, "solve_pose_gap_m": gap}


def _finite_max(x: torch.Tensor) -> float:
    if x.numel() == 0:
        return 0.0
    return float(torch.where(torch.isfinite(x), x, torch.full_like(x, math.inf)).max())


def setup(cell, seed: int, device) -> LogRun:
    return LogRun(cell.config, cell.config_path, cell.mix, cell.limits, seed, device)
