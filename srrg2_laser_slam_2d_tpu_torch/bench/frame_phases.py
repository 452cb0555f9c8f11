"""Where the two tracking-frame kernels spend a frame, on the card: kernel 1
(``csrc/frame_kernel.cu``) on the first 1,024-frame corridor chunk and on
single frames (T = 1, as the per-message loop launches it), kernel 3
(``csrc/stream_kernel.cu``) on ``bench/stream_bench.py``'s inputs (255
frames broadcast to K streams).

    python -m srrg2_laser_slam_2d_tpu_torch.bench.frame_phases [--out FILE]
        [--sweep 1,2,3]

Each kernel is built three ways from the package's ``csrc``, into
``build/torch_kernels/phases/``, and called through its C entry point with
the wrapper's arguments:
  - the default build (the wrappers' flags): milliseconds per launch, CUDA
    events, mean of 5 after a warm-up (kernel 3 at K = 8, 32, 128; kernel 1
    per chunk); kernel 1's T = 1 launch as device time (the queue kept full
    behind large matrix products) and at the host's pace;
  - with ``-DFRAME_PHASE_TIMING``: thread 0 of block 0 stamps ``clock64()``
    at the phase boundaries of the frame step; SM cycles per frame for each phase, and
    microseconds at the clock those cycles and the build's own launch time
    imply;
  - with ``-DFRAME_COUNT_BARRIERS`` as well: block barriers per frame.
``--sweep`` builds the three ways once per beams-per-thread setting
(``-DFRAME_BPT=n``) and reports each; the kernel's outputs under each
setting are held against the default build's (decisions, poses).
Prints one JSON object and writes it to ``--out``. Times against other
sources (an older commit's) are ``bench/compare_csrc.py``'s.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from .._device import card_description, resolve_device
from ..ops import _cuda
from ..ops.frame_kernel import FRAME_TRACK_GRID, PHASE_CYCLES
from ..ops.stream_kernel import STREAM_TRACK_GRID

PHASES = ("frame start (canvas load)", "fields + gather + terms", "reduction", "update",
          "final pass", "merge z-buffer", "scan", "payload store")
CHUNK = 1024
STREAM_FRAMES = 256
KS = (8, 32, 128)
REPS = 5
ENTRY = {"frame_kernel": FRAME_TRACK_GRID, "stream_kernel": STREAM_TRACK_GRID}


def build(bpts) -> dict:
    """Every variant's library path: {(bpt, kind): {kernel: path}}, kind
    one of "default", "timing", "count"; bpt None = the source's own."""
    flags = {"default": (), "timing": ("-DFRAME_PHASE_TIMING",),
             "count": ("-DFRAME_PHASE_TIMING", "-DFRAME_COUNT_BARRIERS")}
    jobs, paths = [], {}
    for bpt in bpts:
        for kind, extra in flags.items():
            sub = kind + ("" if bpt is None else f"_bpt{bpt}")
            extra = extra + (() if bpt is None else (f"-DFRAME_BPT={bpt}",))
            for name in ENTRY:
                lib = _cuda.BUILD_DIR / "phases" / sub / f"lib{name}.so"
                jobs.append((f"{sub}/{name}", _cuda.CSRC / f"{name}.cu", lib, extra))
                paths.setdefault((bpt, kind), {})[name] = lib
    logs = _cuda.compile_all(jobs)
    regs = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
            for k, v in logs.items() if "/default" in k}
    return paths, regs


def load(paths: dict) -> dict:
    """The entry points of one variant's libraries: {kernel: (its launch,
    its phase cycles)}."""
    return {name: (ENTRY[name].bind(path), PHASE_CYCLES.bind(path))
            for name, path in paths.items()}


class Inputs:
    """The kernels' inputs at the main paths' shapes, on the card."""

    def __init__(self, device):
        from ..models import fast_tracker as ft
        from ..models.slam import frame_spec
        from ..utils import config as config_mod
        from . import corridor_e2e, stream_bench

        mgr = config_mod.ConfigManager.read("configurations/corridor.json")
        slam_cfg, pcfg = mgr.get_by_name("slam"), mgr.get_by_name("preprocessor")
        self.fspec = dataclasses.replace(frame_spec(slam_cfg),
                                         split_distance=slam_cfg.local_map_distance)
        clouds, odoms = corridor_e2e.first_frames(corridor_e2e.load_messages(), CHUNK + 1,
                                                  pcfg, device)
        st = ft.seed(self.fspec, clouds.map(lambda x: x[0]), np.zeros(3, np.float32),
                     odom=odoms[0])
        self.cacheT, self.pose = st.cacheT, st.pose
        self.measC = ft.pack_measurement_canvas_batch(
            self.fspec, clouds.map(lambda x: x[1:]), torch.from_numpy(odoms[1:]).to(device))
        self.sspec, state0, measS, odS = stream_bench.build_inputs(STREAM_FRAMES, device=device)
        self.streams = {}
        for k in KS:
            cacheB, poseB, measB, odomB, _ = stream_bench._broadcast(state0, measS, odS, k)
            self.streams[k] = tuple(x.contiguous() for x in (measB, odomB, cacheB, poseB))


def launcher(libs, inp: Inputs, which: str, arg):
    """A function that launches one kernel of ``libs`` on ``inp`` and
    returns its outputs (no synchronisation)."""
    from ..ops.frame_kernel import _params

    if which == "frame_kernel":
        measC = inp.measC[:arg].contiguous()
        T, B = measC.shape[0], measC.shape[2]
        params = _params(inp.fspec, T)
        ins = (measC, inp.cacheT, inp.pose)
        out = (torch.empty_like(inp.cacheT), torch.empty_like(inp.pose),
               torch.empty((T, 8, B), device=measC.device))
    else:
        measB, odomB, cacheB, poseB = inp.streams[arg]
        T, _, K, B = measB.shape
        params = _params(inp.sspec, T, K)
        ins = (measB, odomB, cacheB, poseB)
        out = (torch.empty_like(cacheB), torch.empty_like(poseB),
               torch.empty((T, 8, K, B), device=measB.device))
    entry = libs[which][0]
    device = ins[0].device
    ptrs = [t.data_ptr() for t in (*ins, *out)]

    def launch():
        entry(device, *ptrs, ctypes.addressof(params))
        return out
    return launch


def events_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` runs after a
    warm-up run (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean DEVICE milliseconds of ``fn``: the runs are enqueued behind
    three large matrix products, so they execute back to back whatever the
    host's pace."""
    x = torch.randn(8192, 8192, device="cuda")
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        x @ x
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    busy = not start.query()
    torch.cuda.synchronize()
    if not busy:
        raise RuntimeError("the host did not keep the queue full")
    return start.elapsed_time(end) / reps


def phase_table(libs, inp: Inputs, which: str, arg, frames: int) -> dict:
    """Cycles per frame of each phase (block 0), from the timing build."""
    launch = launcher(libs, inp, which, arg)
    ms = events_ms(launch, 2)             # the stamps of the last launch stay
    buf = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    libs[which][1](inp.cacheT.device, ctypes.addressof(buf))
    cycles = [buf[i] / frames for i in range(len(PHASES))]
    ghz = sum(cycles) * frames / (ms * 1e6)
    return {"cycles_per_frame": dict(zip(PHASES, cycles)),
            "us_per_frame": {p: c / (ghz * 1e3) for p, c in zip(PHASES, cycles)},
            "total_us_per_frame": sum(cycles) / (ghz * 1e3),
            "timing_build_ms": ms, "implied_sm_ghz": ghz}


def barriers(libs, inp: Inputs, which: str, arg, frames: int) -> float:
    """Block barriers per frame (block 0) over ONE launch of the count build."""
    launch = launcher(libs, inp, which, arg)
    launch()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    libs[which][1](inp.cacheT.device, ctypes.addressof(buf))
    return buf[len(PHASES)] / frames


def measure(libs: dict, inp: Inputs) -> dict:
    """Default build: ms per launch of both kernels."""
    k1 = launcher(libs["default"], inp, "frame_kernel", CHUNK)
    k1_single = launcher(libs["default"], inp, "frame_kernel", 1)
    out = {"frame_kernel": {"chunk_ms": events_ms(k1),
                            "t1_device_ms": device_ms(k1_single, 200),
                            "t1_host_paced_ms": events_ms(k1_single, 200)},
           "stream_kernel": {"ms": {k: events_ms(launcher(libs["default"], inp,
                                                          "stream_kernel", k))
                                    for k in KS}}}
    out["frame_kernel"]["phases"] = phase_table(libs["timing"], inp, "frame_kernel", CHUNK,
                                                CHUNK)
    out["stream_kernel"]["phases"] = phase_table(libs["timing"], inp, "stream_kernel", 32,
                                                 STREAM_FRAMES - 1)
    out["frame_kernel"]["barriers_per_frame"] = barriers(libs["count"], inp, "frame_kernel",
                                                         CHUNK, CHUNK)
    out["stream_kernel"]["barriers_per_frame"] = barriers(libs["count"], inp, "stream_kernel",
                                                          32, STREAM_FRAMES - 1)
    return out


def agreement(libs: dict, ref: dict, inp: Inputs) -> dict:
    """A variant's outputs against the reference build's on the same inputs:
    the fraction of equal merge decisions and the largest estimate
    difference (the variants differ only in the order of their sums)."""
    out = {}
    for which, arg in (("frame_kernel", CHUNK), ("stream_kernel", 32)):
        a = launcher(libs, inp, which, arg)()[2]
        b = launcher(ref, inp, which, arg)()[2]
        torch.cuda.synchronize()
        out[which] = {"decisions_equal": float(((a[:, 4] == b[:, 4]) & (a[:, 5] == b[:, 5]))
                                               .float().mean()),
                      "estimate_max_abs_diff": float((a[:, 6, ..., 0:3]
                                                      - b[:, 6, ..., 0:3]).abs().max())}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sweep", default="", help="beams per thread to sweep, e.g. 1,2,3")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    device = resolve_device(None)
    bpts = [None] + [int(s) for s in args.sweep.split(",") if s]
    paths, regs = build(bpts)
    inp = Inputs(device)
    result = {"card": card_description(device), "ptxas": regs, "variants": {}}
    ref = None
    for bpt in bpts:
        libs = {kind: load(paths[(bpt, kind)]) for kind in ("default", "timing", "count")}
        key = "source default" if bpt is None else f"bpt={bpt}"
        result["variants"][key] = measure(libs, inp)
        if ref is None:
            ref = libs["default"]
        else:
            result["variants"][key]["against_source_default"] = agreement(libs["default"],
                                                                          ref, inp)
        print(json.dumps({key: result["variants"][key]}), flush=True)
    result["sm_clock"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(result))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
