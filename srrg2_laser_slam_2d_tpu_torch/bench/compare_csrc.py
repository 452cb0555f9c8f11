"""Every kernel call that ``chip_smoke.py`` times, built from other CUDA
sources and from the package's own, timed in turns on the card; then the
phase tables of kernels 2 and 6.

    python -m srrg2_laser_slam_2d_tpu_torch.bench.compare_csrc --csrc DIR
        [--out chiprun_out/compare.json]

Run it from the repository root. ``DIR`` holds the other sources, e.g. an
older commit's ``csrc`` unpacked under ``build/``::

    mkdir -p build/parent && git archive <commit> srrg2_laser_slam_2d_tpu_torch/csrc \\
        | tar -x -C build/parent

The inputs are ``chip_smoke.py``'s own: its check functions run once on
the package's build (each kernel against its plain version, the corridor
run whose largest NN-ICP batch is kept, the MULTI drive), and every call
they time (``chip_smoke.KERNEL_TIMINGS``) is timed again through the same
wrapper from the other build and from the package's, in turns (other,
own, own, other). Then a ``-DFRAME_PHASE_TIMING`` build of the package's
kernels 2 and 6 gives their phase tables (thread 0 of block 0 stamps
``clock64()`` at each phase boundary: SM cycles per launch of each phase),
and each build's estimates on the corridor batch are held against the
plain version's. Kernels 1 and 3's phase tables, barrier counts and
beams-per-thread sweep are ``bench/frame_phases.py``'s. Prints one JSON
object and writes it to ``--out``.
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

PHASE_NAMES = {
    "nn_icp_kernel": ("pack the valid points", "pass constants", "nearest-neighbour scan",
                      "combine + match", "solve terms", "reduction", "update", "final stats"),
    "multicue_align_kernel": ("canvases + rows", "cue poses", "rows: fields, gather, terms",
                              "warp sums", "reduction", "remap + update")}


def use_build(csrc: Path, build_dir: Path) -> None:
    """Point the kernel wrappers at the libraries built from ``csrc`` into
    ``build_dir``."""
    _cuda.CSRC, _cuda.BUILD_DIR = Path(csrc), Path(build_dir)
    _cuda._LIBS.clear()


def phase_cycles(name: str) -> list[int]:
    """The SM cycles of each phase over the last launch of kernel ``name``
    (a -DFRAME_PHASE_TIMING build; thread 0 of block 0)."""
    lib = _cuda.load(name)
    lib.frame_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.frame_phase_cycles.restype = ctypes.c_int
    out = (ctypes.c_ulonglong * 9)()
    err = lib.frame_phase_cycles(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"reading the phase cycles failed: {_cuda.error_string(err)}")
    return [int(v) for v in out[:len(PHASE_NAMES[name])]]


def compare(other: Path, smoke) -> dict:
    """See the module docstring; ``smoke`` is the ``chip_smoke`` module."""
    from ..bench import corridor_e2e
    from ..ops import nn_icp_kernel as nk
    from ..utils import config as config_mod

    device = torch.device("cuda")
    own = (_cuda.CSRC, _cuda.BUILD_DIR)
    ab = _cuda.BUILD_DIR / "ab"
    builds = {"other": (other, ab / "other"), "own": own}
    jobs = [(f"other/{n}", other / f"{n}.cu", ab / "other" / f"lib{n}.so", ())
            for n in _cuda.KERNELS]
    jobs += [(f"own/{n}", own[0] / f"{n}.cu", own[1] / f"lib{n}.so", ()) for n in _cuda.KERNELS]
    jobs += [(f"timing/{n}", own[0] / f"{n}.cu", ab / "timing" / f"lib{n}.so",
              ("-DFRAME_PHASE_TIMING",)) for n in PHASE_NAMES]
    t0 = time.perf_counter()
    logs = _cuda.compile_all(jobs)
    smoke.log(f"built {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s")
    for key, text in logs.items():
        if key.startswith("own/nn") or key.startswith("own/multicue"):
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    smoke.log(f"  {key}: {line.strip()}")

    # every check once on the package's own build: fills KERNEL_TIMINGS
    mgr = config_mod.ConfigManager.read("configurations/corridor.json")
    slam_cfg, pcfg = mgr.get_by_name("slam"), mgr.get_by_name("preprocessor")
    msgs = corridor_e2e.load_messages()
    smoke.check_frame_kernel(msgs, slam_cfg, pcfg, device)
    smoke.check_nn_icp_kernel(slam_cfg.detector, device)
    smoke.check_stream_kernel(device)
    smoke.check_message_kernels(msgs, slam_cfg, pcfg, device)
    capture = smoke.DetectionCapture()
    smoke.corridor_run("configurations/corridor.json", msgs, device, capture)
    corridor_check = smoke.check_nn_icp_corridor(capture.batch)
    dual, _ = smoke.dual_drive(device)
    smoke.check_multicue_kernel(dual, device)
    smoke.check_probes(dual, device)

    rounds = []
    for label in ("other", "own", "own", "other"):
        use_build(*builds[label])
        times = {name: method(fn, reps)
                 for name, (method, fn, reps) in smoke.KERNEL_TIMINGS.items()}
        smoke.log(f"{label}: " + json.dumps(times))
        rounds.append({"build": label, "ms": times})

    phases = {}
    use_build(own[0], ab / "timing")
    for name, label in (("nn_icp_kernel", "nn_icp_kernel"),
                        ("nn_icp_kernel", "nn_icp_kernel corridor batch"),
                        ("multicue_align_kernel", "multicue_align_kernel")):
        method, fn, reps = smoke.KERNEL_TIMINGS[label]
        ms = method(fn, reps)
        fn()
        torch.cuda.synchronize()
        cyc = phase_cycles(name)
        phases[label] = {"ms_with_stamps": ms, "cycles": dict(zip(PHASE_NAMES[name], cyc)),
                         "total_cycles": sum(cyc), "clock_ghz": sum(cyc) / ms * 1e-6}
        smoke.log(f"phases of {label}: {json.dumps(phases[label])}")

    # each build's estimates on the corridor batch against the plain version's
    fixed, moving, initials, kw = capture.batch
    plain = nk._result(*nk.fused_align_pairs_plain(
        nk.pack_fixed(fixed), nk.pack_moving(moving), initials, kw["iterations"],
        float(kw["max_distance"]) ** 2, float(kw["normal_cos"]), float(kw["chi_threshold"]),
        int(kw["min_inliers"]), int(kw["corr_refresh"])))
    pair_err = {}
    for label in ("other", "own"):
        use_build(*builds[label])
        r = nk.fused_align_pairs(fixed, moving, initials, **kw)
        pair_err[label] = (r.estimate - plain.estimate).abs().amax(1).cpu().numpy().tolist()
        smoke.log(f"corridor batch, {label} build against the plain version: max per pair "
                  f"{max(pair_err[label]):.3g}, pairs above 1e-3 "
                  f"{sum(e > 1e-3 for e in pair_err[label])}")
    use_build(*own)
    return {"rounds": rounds, "phases": phases, "corridor_batch": corridor_check,
            "corridor_pair_err": pair_err}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--csrc", type=Path, required=True,
                    help="the other CUDA sources, timed in turns with the package's own")
    ap.add_argument("--out", default="chiprun_out/compare.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_csrc: no CUDA device")
    from .._device import card_description

    # chip_smoke.py sits at the repository root, beside the package
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    result = {"card": card_description(torch.device("cuda")), "other": str(args.csrc),
              **compare(args.csrc.resolve(), chip_smoke)}
    print(json.dumps(result))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
