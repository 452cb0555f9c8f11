"""Every kernel call that ``chip_smoke.py`` times, built from other CUDA
sources and from the package's own, timed in turns on the card; then the
phase tables of kernels 2, 4, 5, 6, 7, 8 and the two probes.

    python -m srrg2_laser_slam_2d_tpu_torch.bench.compare_csrc --csrc DIR
        [--routes] [--clusters] [--only message-kernels | --only probes]
        [--out chiprun_out/compare.json]

Run it from the repository root. ``DIR`` holds the other sources, e.g. an
older commit's ``csrc`` unpacked under ``build/``::

    mkdir -p build/parent && git archive <commit> srrg2_laser_slam_2d_tpu_torch/csrc \\
        | tar -x -C build/parent

The inputs are ``chip_smoke.py``'s own: its check functions run once on
the package's build (each kernel against its plain version, the corridor
run whose largest NN-ICP batch is kept, the MULTI drive and its probes),
and every call they time (``chip_smoke.KERNEL_TIMINGS``) is timed again
through the same wrapper from the other build and from the package's, in
turns (other, own, own, other). Then a ``-DFRAME_PHASE_TIMING`` build of
the package's kernels 2, 4, 5, 6, 7, 8 and the two probes gives their phase
tables (thread 0 of block 0 stamps ``clock64()`` at each phase boundary: SM
cycles per launch of each phase), and each build's estimates on the
corridor batch are held against the plain version's. Kernels 1 and 3's
phase tables, barrier counts and beams-per-thread sweep are
``bench/frame_phases.py``'s. ``--only message-kernels`` takes the
per-message loop's kernels (8, 7, 5, 4) alone, ``--only probes`` the two
probe kernels (9a, 9b) on the MULTI drive's scans, each for a short call;
``--only`` takes neither ``--routes`` nor ``--clusters``.

``--routes`` adds the per-message routes that launch kernels 5, 4, 7 and 8
(``chip_smoke.py``'s A, B, B ``reuse_clip_canvas`` and C with the kernel
z-buffer, 600 corridor frames each) from both builds in turns: wall, track
and relocalize phases, launches, and each kernel's calls by (points,
clouds); then every shape of those histograms timed from both builds in
turns on clouds cut from the tracked scene, and the launch-weighted time
of each kernel over its route's histogram. The aligners run at one shape
a route (the scan against the clip), so theirs is the route's launches
times each round's device time of that call.

``--clusters`` times the package's kernels 8 and 7 at each cluster size
(1, 2, 4, 8 blocks a cloud, in place of ``cluster_blocks``' choice) on a
seeded synthetic cloud of 8,192 rows (uniform over 20 m x 20 m, 721 beams
over +-pi; 3,200 and 8,192 of them valid), kernel 8 also on batches of 4
and 16 such clouds in one launch.

Every build is called through the package's own wrappers and entry-point
declarations (``_cuda.use_build`` rebinds them), so the other sources must
take the C interfaces of the package's (those since kernels 7 and 8 took
batches, int64 indices and a finished canvas). Prints one JSON object and
writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

import torch

from ..ops import _cuda
from ..ops import projector_kernel as pk
from ..ops import scene_kernel as sk
from ..ops.frame_kernel import PHASE_CYCLES

PHASE_NAMES = {
    "nn_icp_kernel": ("pack the valid points", "pass constants", "nearest-neighbour scan",
                      "combine + match", "solve terms", "reduction", "update", "final stats"),
    "multicue_align_kernel": ("canvases + rows", "cue poses", "rows: fields, gather, terms",
                              "warp sums", "reduction", "remap + update"),
    "projector_kernel": ("init keys", "loads + beam assignment", "key atomics",
                         "keys to the owners + cluster barrier", "owners: min + write"),
    "scene_kernel": ("init (+ camera cos, sin)", "rows: loads, camera frame, beam",
                     "pass 1: key atomics", "keys to the owners + barrier 1",
                     "owners: min + write", "barrier 2",
                     "pass 2: tied rows count at the owner, add their fields",
                     "barrier 3 + owners divide ties"),
    "banded_align_kernel": ("loads + fixed rows' fields + clear", "fixed z-buffer (2 barriers)",
                            "canvas finish + lane packing",
                            "passes: fields + gather + match (+ prior)",
                            "reduction + warp 0's update (2 barriers)"),
    "projective_align_kernel": ("loads + fixed rows' fields + clear",
                                "fixed z-buffer (2 barriers)", "fixed cells + row packing",
                                "passes: fields + atomicMin + barrier 1",
                                "tie count + sums + barrier 2",
                                "owners: match + reset (+ prior)",
                                "reduction + warp 0's update (2 barriers)"),
    "beam_zbuffer_kernel": ("zero rows stored, loads issued, slots cleared + barrier",
                            "load wait + fields + depth atomicMin", "barrier + lane atomicMax",
                            "barrier", "winner reads + stores"),
    "gather_probe_kernel": ("row staged (bulk copy, halo, barrier, wait)", "passes",
                            "store")}
ROUTES = ("A", "B", "B reuse_clip_canvas", "C kernel z-buffer")
# each kernel's histogram is read on the route named
HISTOGRAM_ROUTE = {"projector_kernel": "C kernel z-buffer", "scene_kernel": "B"}
# the aligners run at one shape per route: launches x the call's device time
ALIGNER_ROUTE = {"banded_align_kernel": "A", "projective_align_kernel": "B"}


def phase_cycles(name: str) -> list[int]:
    """The SM cycles of each phase over the last launch of kernel ``name``
    (a -DFRAME_PHASE_TIMING build; thread 0 of block 0)."""
    out = (ctypes.c_ulonglong * 9)()
    PHASE_CYCLES.bind(_cuda.library_path(name))(torch.device("cuda"), ctypes.addressof(out))
    return [int(v) for v in out[:len(PHASE_NAMES[name])]]


def _cut(cloud, n: int):
    """The first ``n`` points of every cloud of ``cloud`` (tiled where it
    holds fewer)."""
    from ..utils.cloud import Cloud

    reps = -(-n // cloud.capacity)

    def cut(x, axis):
        return torch.cat([x] * reps, dim=axis).narrow(axis, 0, n).contiguous()

    return Cloud(cut(cloud.xy, cloud.xy.dim() - 2), cut(cloud.normal, cloud.xy.dim() - 2),
                 cut(cloud.valid, cloud.valid.dim() - 1))


def shape_calls(smoke, proj, histograms: dict, scene, X, S) -> dict:
    """name -> {"NxJ": call} for kernels 7 and 8 at every shape of their
    histogram, on clouds cut from the tracked scene: kernel 8 on J views of
    it, kernel 7 on it seen from the robot."""
    from ..utils import geometry

    cam = geometry.compose(X, S)
    out = {}
    for name, hist in histograms.items():
        out[name] = {}
        for key in hist:
            n, J = (int(v) for v in key.split("x"))
            if name == "projector_kernel":
                views = _cut(smoke.scene_views(scene, X, S, J), n)
                if J == 1:
                    views = views.map(lambda x: x[0])
                out[name][key] = lambda v=views: pk.project_local(proj, v.xy, v.valid)
            else:
                cloud = _cut(scene, n)
                out[name][key] = lambda c=cloud: sk.canvas(proj, c, cam)
    return out


def route_rounds(smoke, builds, slam_cfg, pcfg, msgs, device) -> list:
    """``ROUTES`` from each build in turns (other, own, own, other)."""
    rounds = []
    for label in ("other", "own", "own", "other"):
        _cuda.use_build(*builds[label])
        for route in ROUTES:
            name, flags, backend = next(r for r in smoke.MESSAGE_ROUTES if r[0] == route)
            out, _ = smoke.message_route_run(name, flags, backend, slam_cfg, pcfg, msgs, device)
            phases = out["phases"]
            row = {"build": label, "route": route, "wall_s": out["wall_s"],
                   "track_s": phases.get("track"), "relocalize_s": phases.get("relocalize"),
                   "launches": out["launches"], "calls": out["calls"],
                   "ate_rmse_translation_m": out["ate_rmse_translation_m"]}
            smoke.log(f"route {route}, {label} build: {json.dumps(row)}")
            rounds.append(row)
    return rounds


def cluster_sweep(smoke, device) -> list:
    """``--clusters``: see the module docstring."""
    from unittest import mock

    import numpy as np

    from ..ops.projector import PolarProjection
    from ..utils.cloud import Cloud

    proj = PolarProjection.make(cols=721, angle_min=-np.pi, angle_max=np.pi, range_min=0.0,
                                range_max=30.0)
    rng = np.random.default_rng(0)
    n = 8192
    xy = torch.as_tensor(rng.uniform(-10, 10, (n, 2)), dtype=torch.float32, device=device)
    nm = torch.nn.functional.normalize(
        torch.as_tensor(rng.normal(size=(n, 2)), dtype=torch.float32, device=device), dim=1)
    cam = torch.tensor([0.3, -0.2, 0.4], device=device)
    picked = pk.cluster_blocks(n)
    rows = []
    for live in (3200, n):
        valid = torch.arange(n, device=device) < live
        scene = Cloud(xy, nm, valid)
        for J in (1, 4, 16):
            X, V = ((xy, valid) if J == 1 else
                    (xy.expand(J, -1, -1).contiguous(), valid.expand(J, -1).contiguous()))
            calls = {"projector_kernel": lambda: pk.project_local(proj, X, V)}
            if J == 1:
                calls["scene_kernel"] = lambda: sk.canvas(proj, scene, cam)
            for cluster in (1, 2, 4, 8):
                with mock.patch.object(pk, "cluster_blocks", lambda _n: cluster), \
                        mock.patch.object(sk, "cluster_blocks", lambda _n: cluster):
                    for name, fn in calls.items():
                        row = {"kernel": name, "n": n, "valid": live, "clouds": J,
                               "cluster": cluster, "picked": cluster == picked,
                               "ms": smoke.device_time_ms(fn, 100)}
                        smoke.log(f"cluster sweep: {json.dumps(row)}")
                        rows.append(row)
    return rows


def compare(other: Path, smoke, routes: bool = False, clusters: bool = False,
            only: str | None = None) -> dict:
    """See the module docstring; ``smoke`` is the ``chip_smoke`` module."""
    from ..bench import corridor_e2e
    from ..ops import nn_icp_kernel as nk
    from ..utils import config as config_mod

    device = torch.device("cuda")
    own = (_cuda.CSRC, _cuda.BUILD_DIR)
    ab = _cuda.BUILD_DIR / "ab"
    builds = {"other": (other, ab / "other"), "own": own}
    # a kernel newer than the other sources is built from the package's own
    jobs = [(f"other/{n}", (other if (other / f"{n}.cu").exists() else own[0]) / f"{n}.cu",
             ab / "other" / f"lib{n}.so", ()) for n in _cuda.KERNELS]
    jobs += [(f"own/{n}", own[0] / f"{n}.cu", own[1] / f"lib{n}.so", ()) for n in _cuda.KERNELS]
    jobs += [(f"timing/{n}", own[0] / f"{n}.cu", ab / "timing" / f"lib{n}.so",
              ("-DFRAME_PHASE_TIMING",)) for n in PHASE_NAMES]
    t0 = time.perf_counter()
    logs = _cuda.compile_all(jobs)
    smoke.log(f"built {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s")
    for key, text in logs.items():
        if key.startswith(("own/nn", "own/multicue", "own/projector", "own/scene",
                           "own/banded", "own/projective", "own/beam", "own/gather")):
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    smoke.log(f"  {key}: {line.strip()}")

    # every check once on the package's own build: fills KERNEL_TIMINGS
    mgr = config_mod.ConfigManager.read("configurations/corridor.json")
    slam_cfg, pcfg = mgr.get_by_name("slam"), mgr.get_by_name("preprocessor")
    msgs = corridor_e2e.load_messages()
    if only is None:
        smoke.check_frame_kernel(msgs, slam_cfg, pcfg, device)
        smoke.check_nn_icp_kernel(slam_cfg.detector, device)
        smoke.check_stream_kernel(device)
    if only in (None, "message-kernels"):
        smoke.check_message_kernels(msgs, slam_cfg, pcfg, device)
    if only is None:
        capture = smoke.DetectionCapture()
        smoke.corridor_run("configurations/corridor.json", msgs, device, capture)
        corridor_check = smoke.check_nn_icp_corridor(capture.batch)
    if only in (None, "probes"):
        dual, _ = smoke.dual_drive(device)
        if only is None:
            smoke.check_multicue_kernel(dual, device)
        smoke.check_probes(dual, device)

    rounds = []
    for label in ("other", "own", "own", "other"):
        _cuda.use_build(*builds[label])
        times = {name: method(fn, reps)
                 for name, (method, fn, reps) in smoke.KERNEL_TIMINGS.items()}
        smoke.log(f"{label}: " + json.dumps(times))
        rounds.append({"build": label, "ms": times})

    phases = {}
    _cuda.use_build(own[0], ab / "timing")
    # every device timing of the stamped kernels (block 0 of the last launch)
    stamped = [(label.split(" ")[0], label) for label in smoke.KERNEL_TIMINGS
               if label.split(" ")[0] in PHASE_NAMES and not label.endswith(" paced")]
    for name, label in stamped:
        method, fn, reps = smoke.KERNEL_TIMINGS[label]
        ms = method(fn, reps)
        fn()
        torch.cuda.synchronize()
        cyc = phase_cycles(name)
        phases[label] = {"ms_with_stamps": ms, "cycles": dict(zip(PHASE_NAMES[name], cyc)),
                         "total_cycles": sum(cyc), "clock_ghz": sum(cyc) / ms * 1e-6}
        smoke.log(f"phases of {label}: {json.dumps(phases[label])}")

    result = {"rounds": rounds, "phases": phases}
    if only is not None:
        _cuda.use_build(*own)
        return result
    # each build's estimates on the corridor batch against the plain version's
    fixed, moving, initials, kw = capture.batch
    plain = nk._result(*nk.fused_align_pairs_plain(
        nk.pack_fixed(fixed), nk.pack_moving(moving), initials, kw["iterations"],
        float(kw["max_distance"]) ** 2, float(kw["normal_cos"]), float(kw["chi_threshold"]),
        int(kw["min_inliers"]), int(kw["corr_refresh"])))
    pair_err = {}
    for label in ("other", "own"):
        _cuda.use_build(*builds[label])
        r = nk.fused_align_pairs(fixed, moving, initials, **kw)
        pair_err[label] = (r.estimate - plain.estimate).abs().amax(1).cpu().numpy().tolist()
        smoke.log(f"corridor batch, {label} build against the plain version: max per pair "
                  f"{max(pair_err[label]):.3g}, pairs above 1e-3 "
                  f"{sum(e > 1e-3 for e in pair_err[label])}")
    _cuda.use_build(*own)
    result.update(corridor_batch=corridor_check, corridor_pair_err=pair_err)
    if routes:
        result.update(routes_and_histograms(smoke, builds, mgr, msgs, device, rounds))
    if clusters:
        result["clusters"] = cluster_sweep(smoke, device)
    return result


def routes_and_histograms(smoke, builds, mgr, msgs, device, rounds) -> dict:
    """``--routes``: see the module docstring. ``rounds``: the builds' device
    times of every timed call, in turns."""
    slam_cfg, pcfg = mgr.get_by_name("slam"), mgr.get_by_name("preprocessor")
    route_rows = route_rounds(smoke, builds, slam_cfg, pcfg, msgs, device)
    first_own = {r["route"]: r for r in route_rows if r["build"] == "own"}
    histograms = {name: first_own[route]["calls"][name]
                  for name, route in HISTOGRAM_ROUTE.items()}
    scene, X, S, _, _ = smoke.tracked_scene(msgs, slam_cfg, pcfg, device)
    calls = shape_calls(smoke, slam_cfg.tracker.projection, histograms, scene, X, S)
    shape_rounds = []
    for label in ("other", "own", "own", "other"):
        _cuda.use_build(*builds[label])
        ms = {name: {key: smoke.device_time_ms(fn, max(4, 64 // int(key.split("x")[1])))
                     for key, fn in fns.items()}
              for name, fns in calls.items()}
        weighted = {name: sum(histograms[name][key] * t for key, t in ms[name].items())
                    for name in ms}
        row = {"build": label, "ms": ms, "launch_weighted_ms": weighted}
        smoke.log(f"histogram shapes, {label} build: {json.dumps(row)}")
        shape_rounds.append(row)
    _cuda.use_build(*builds["own"])
    aligners = [{"build": r["build"],
                 "launch_weighted_ms": {name: first_own[route]["launches"].get(name, 0)
                                        * r["ms"][name]
                                        for name, route in ALIGNER_ROUTE.items()}}
                for r in rounds]
    for row in aligners:
        smoke.log(f"aligners over their routes: {json.dumps(row)}")
    return {"routes": route_rows, "histograms": histograms, "histogram_shapes": shape_rounds,
            "aligner_launch_weighted": aligners}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--csrc", type=Path, required=True,
                    help="the other CUDA sources, timed in turns with the package's own")
    ap.add_argument("--routes", action="store_true",
                    help="also the routes that launch kernels 7 and 8, and their histograms")
    ap.add_argument("--clusters", action="store_true",
                    help="also the package's kernels 7 and 8 at each cluster size")
    ap.add_argument("--only", choices=["message-kernels", "probes"], default=None,
                    help="time only the per-message loop's kernels (8, 7, 5, 4) or the two "
                         "probes (9a, 9b); no routes")
    ap.add_argument("--out", default="chiprun_out/compare.json")
    args = ap.parse_args()
    if args.only and (args.routes or args.clusters):
        ap.error("--only takes neither --routes nor --clusters")
    if not torch.cuda.is_available():
        raise SystemExit("compare_csrc: no CUDA device")
    from .._device import card_description

    # chip_smoke.py sits at the repository root, beside the package
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    result = {"card": card_description(torch.device("cuda")), "other": str(args.csrc),
              **compare(args.csrc.resolve(), chip_smoke, args.routes, args.clusters,
                        args.only)}
    print(json.dumps(result))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
