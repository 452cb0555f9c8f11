"""One run of one cell: set-up, warm-up, the measured window, the check,
one JSON line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration's file, its traffic mix ``traffic/<traffic>.json`` (which
names its generator module ``traffic/<generator>.py``), its limits in
``workloads/<cell>.json``, and each per-layer metric's reader
``metrics/<metric>.py``. Adding a cell, a mix or a metric adds files and
entries; no file here changes.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
# top-level module names no run may load (compared whole: the port's name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "srrg2_laser_slam_2d_tpu")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell's entries and files, resolved by name."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        cfg = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config_path = root / cfg["file"]
        self.config = load_json(self.config_path)
        self.mix = load_json(BENCH / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(BENCH / "workloads" / f"{name}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]


def loaded_forbidden() -> list[str]:
    """Top-level names in ``sys.modules`` that a run may not load."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What a per-layer metric reader reads: the cell's name, the run (its
    ``info`` and whatever the traffic kept), the trace."""

    def __init__(self, cell: str, run, trace):
        self.cell, self.run, self.trace = cell, run, trace


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """Set-up, warm-up, window, check. Returns the result object (the last
    line), its ``check`` entries last."""
    import torch

    from . import trace as trace_mod

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    gen = importlib.import_module(f"benchmark.traffic.{cell.mix['generator']}")
    run = gen.setup(cell, seed, device)
    run.warm_up()
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    log(f"[{cell.name}] seed {seed}: set-up {setup_s:.3f} s")

    tr = None
    if trace:
        with trace_mod.profiled() as holder:
            with trace_mod.span(trace_mod.WINDOW):
                e2e = run.run_window(seconds, trace_mod.span)
        tr = holder.trace
    else:
        e2e = run.run_window(seconds)
    if on_card:
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
    else:
        peak = 0
    e2e["setup_s"] = setup_s

    metrics = {}
    if trace:
        ctx = Context(cell.name, run, tr)
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    run.release()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = run.check()
    log(f"[{cell.name}] check {time.perf_counter() - t_check:.3f} s")
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in numbers)

    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cell.chips if on_card else 0,
                   "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": run.attempted(), "failed": run.failed(),
           "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s()
        out["breakdown"] = tr.breakdown()
    out["check"] = {n: {"value": v, "limit": lim} for n, v, lim in numbers}
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float, device=None) -> int:
    """The command's body. ``device`` None means the card, refused when
    there is none or too few; tests pass ``"cpu"`` to drive the rest of a
    run without one."""
    args = parse(argv)
    cell = Cell(args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            log(f"{cell.name} needs {cell.chips} CUDA device(s), found {have}: no result")
            return 2
        device = "cuda"
    out = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device(device), t0)
    bad = loaded_forbidden()
    if bad:
        log(f"the run loaded {', '.join(bad)}: no result")
        return 3
    if out["device"]["platform"] == "gpu":
        import subprocess

        try:
            lim = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=30).stdout.strip()
            log(f"card: {lim}")
        except (OSError, subprocess.SubprocessError) as e:
            log(f"card: nvidia-smi unavailable ({e})")
    for name, c in out["check"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0
