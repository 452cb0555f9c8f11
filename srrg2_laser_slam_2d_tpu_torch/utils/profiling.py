"""Profiling and timing. Counterpart of
``srrg2_laser_slam_2d_tpu/utils/profiling.py``: the reference's
``srrg2_core::Profiler`` and ``SystemUsageCounter::tic/toc`` (per-module
timing, a global enable switch, totals and percentiles), plus the device
hooks: a ``torch.profiler`` trace of a block and the card's idle share over
such a trace.

``timed`` is the program's span recorder. Tracing is on while
``enable_logging`` is true or a ``torch.profiler`` session records; then a
span opens ``torch.profiler.record_function(name)`` (a ``user_annotation``
on the trace's clock, beside the card's kernels and copies), synchronises
the card at its end where the caller passes a ``device``, and records under
``enable_logging``. With tracing off a span reads the host clock alone: no
annotation, no synchronise. Either way it can add its seconds to a
caller's dict (a loop's ``phase_times``). ``span`` makes a whole function
one such span.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

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


def tracing() -> bool:
    """Whether spans are recorded: ``enable_logging`` is on or a
    ``torch.profiler`` session is active."""
    return enable_logging or _autograd_profiler._is_profiler_enabled


class timed:
    """A span over a block (``with timed(...)``). While ``tracing()``, an
    annotation ``name`` on the profiler's trace, and with a CUDA ``device``
    a synchronise at the block's end, so the span holds the work it queued;
    recorded under ``enable_logging``. With tracing off neither annotation
    nor synchronise. Tracing or not, the block's seconds are ``seconds``
    after it and are added to ``times[key]`` where ``times`` is given."""

    def __init__(self, name: str, device=None, times: dict | None = None, key: str = ""):
        self.name, self.device, self.times, self.key = name, device, times, key
        self.annotation = None

    def __enter__(self):
        # the flag first: an annotation costs some 15 us even unrecorded
        if tracing():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.annotation is not None:
            _sync(self.device)
        self.seconds = time.perf_counter() - self.t0
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        if self.times is not None:
            self.times[self.key] = self.times.get(self.key, 0.0) + self.seconds
        if enable_logging:
            _records[self.name].append(self.seconds)
        return False


def span(name: str):
    """Decorator: every call of the function is the span ``name`` (no
    synchronise, no seconds kept)."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with timed(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


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
