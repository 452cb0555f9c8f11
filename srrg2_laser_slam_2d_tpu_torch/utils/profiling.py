"""Profiling and timing. Counterpart of
``srrg2_laser_slam_2d_tpu/utils/profiling.py``: the reference's
``srrg2_core::Profiler`` and ``SystemUsageCounter::tic/toc`` (per-module
timing, a global enable switch, totals and percentiles), plus the device
hooks: a ``torch.profiler`` trace of a block, the card's idle share over
such a trace, and an operation count of a function.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

enable_logging = False  # Profiler::enable_logging equivalent

_records: dict[str, list[float]] = defaultdict(list)
_tic_stack: list[float] = []

# Chrome-trace categories of the work the card does: kernels and copies
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def tic() -> None:
    """SystemUsageCounter::tic."""
    _tic_stack.append(time.perf_counter())


def toc() -> float:
    """SystemUsageCounter::toc: seconds since the matching tic."""
    return time.perf_counter() - _tic_stack.pop()


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(name: str, device=None):
    """Per-module scoped timer; records when ``enable_logging`` is on. With
    a CUDA ``device`` the device is synchronised before each clock reading,
    so the stage's time holds its queued work and none queued before it."""
    _sync(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(device)
        dt = time.perf_counter() - t0
        if enable_logging:
            _records[name].append(dt)


def report() -> dict[str, dict]:
    """Summary stats per timed module."""
    out = {}
    for name, xs in _records.items():
        a = np.asarray(xs)
        out[name] = {
            "count": len(a),
            "total_s": float(a.sum()),
            "mean_s": float(a.mean()),
            "p50_s": float(np.percentile(a, 50)),
            "p95_s": float(np.percentile(a, 95)),
        }
    return out


def reset() -> None:
    _records.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace a block with ``torch.profiler`` (CPU activity, and CUDA
    activity where there is a card) and write it as a Chrome trace. Yields
    the path the trace is written to when the block ends."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def _events(trace) -> list[dict]:
    if isinstance(trace, (str, os.PathLike)):
        with open(trace) as f:
            trace = json.load(f)
    if isinstance(trace, dict):
        trace = trace.get("traceEvents", [])
    return [e for e in trace if e.get("ph") == "X" and "ts" in e and "dur" in e]


def busy_intervals(trace) -> list[tuple[float, float]]:
    """The union of the device's kernel and copy intervals (microseconds,
    sorted, disjoint) in a Chrome trace (a path, the loaded object or its
    event list)."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in _events(trace) if e.get("cat") in DEVICE_CATEGORIES)
    merged: list[tuple[float, float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def idle_share(trace) -> float:
    """One minus the union of the device's kernel and copy intervals over
    the traced window (first event's start to last event's end, host events
    included). Raises when the trace holds no device work."""
    events = _events(trace)
    busy = busy_intervals(events)
    if not busy:
        raise ValueError("the trace holds no kernel or copy on a device")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    return 1.0 - sum(b - a for a, b in busy) / max(t1 - t0, 1e-9)


def compiled_cost(fn, *args, **kwargs) -> dict:
    """Floating-point operations of one call of ``fn`` on example args, as
    ``torch.utils.flop_counter`` counts them; ``{}`` where counting fails."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
        return {"flops": float(counter.get_total_flops())}
    except Exception:
        return {}
