"""The traced run's device timeline, read from ``torch.profiler``'s Chrome
trace (written to the run's temporary directory, read and deleted).

Device work is every kernel, copy and memset on the card; the window is
the benchmark's ``bench.window`` annotation. The idle arithmetic is the
port's ``utils/profiling.idle_share`` (one minus the union of the device's
intervals over the window), copied so that the yardstick does not move
with the program.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import sys
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
# host operations looked at, back from a gap, for the innermost one open
SCAN_BACK = 4096


@dataclass
class Trace:
    """Microseconds on the profiler's clock."""

    device: list = field(default_factory=list)        # (name, start, end, correlation)
    launches: dict = field(default_factory=dict)      # correlation -> host start
    annotations: dict = field(default_factory=dict)   # name -> sorted [(start, end)]
    host_ops: list = field(default_factory=list)      # (start, end, name), main thread
    window: tuple = (0.0, 0.0)

    # ------------------------------------------------------------ reading
    def kernels(self, symbol: str) -> list:
        """Device events whose name holds ``symbol``, inside the window."""
        a, b = self.window
        return [e for e in self.device if symbol in e[0] and e[1] >= a and e[2] <= b]

    def busy_intervals(self) -> list:
        """The union of the device's intervals, clipped to the window."""
        a, b = self.window
        spans = sorted((max(s, a), min(e, b)) for _, s, e, _ in self.device if e > a and s < b)
        merged: list = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def idle_share(self) -> float | None:
        w = self.window_s()
        return None if w <= 0 or not self.device else 1.0 - self.busy_s() / w

    def launched_within(self, name: str) -> list:
        """Device events launched from the host inside the annotation
        ``name``, grouped by the annotation's occurrence."""
        spans = self.annotations.get(name, [])
        starts = [s for s, _ in spans]
        groups: list = [[] for _ in spans]
        for ev in self.device:
            t = self.launches.get(ev[3])
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                groups[i].append(ev)
        return groups

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host operation open at their start."""
        a, b = self.window
        by_op: dict = defaultdict(float)
        for name, s, e, _ in self.device:
            if e > a and s < b:
                by_op[name[:160]] += (min(e, b) - max(s, a)) / 1e6
        gaps = []
        prev = a
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if b > prev:
            gaps.append((prev, b))
        by_host: dict = defaultdict(float)
        ops = self.host_ops
        starts = [o[0] for o in ops]
        for g0, g1 in gaps:
            # innermost host op open at the gap's start: the latest started
            # op that still runs (ops of one thread nest)
            i = bisect.bisect_right(starts, g0) - 1
            name = "host (between operations)"
            for j in range(i, max(i - SCAN_BACK, -1), -1):
                if ops[j][1] >= g0:
                    name = ops[j][2]
                    break
            by_host[name[:160]] += (g1 - g0) / 1e6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}


def read(events: list) -> Trace:
    """The ``Trace`` of a Chrome trace's event list (``torch.profiler``'s
    export): device events by their category, launches by correlation,
    the benchmark's annotations, and the host operations of the thread that
    launched most work."""
    tr = Trace()
    ann: dict = defaultdict(list)
    threads: dict = defaultdict(int)
    host: list = []
    for ev in events:
        if ev.get("ph") != "X" or "ts" not in ev or "dur" not in ev:
            continue
        cat, t0 = ev.get("cat"), float(ev["ts"])
        t1 = t0 + float(ev["dur"])
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_KINDS:
            tr.device.append((ev.get("name", ""), t0, t1, corr))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if corr is not None:
                tr.launches[corr] = t0
            threads[ev.get("tid")] += 1
            host.append((t0, t1, ev.get("name", ""), ev.get("tid")))
        elif cat == "user_annotation":
            ann[ev.get("name", "")].append((t0, t1))
        elif cat == "cpu_op":
            host.append((t0, t1, ev.get("name", ""), ev.get("tid")))
    main = max(threads, key=threads.get) if threads else None
    tr.host_ops = sorted((s, e, n) for s, e, n, t in host if main is None or t == main)
    tr.annotations = {k: sorted(v) for k, v in ann.items()}
    tr.device.sort(key=lambda e: e[1])
    if tr.annotations.get(WINDOW):
        tr.window = tr.annotations[WINDOW][0]
    return tr


@contextlib.contextmanager
def profiled():
    """Profile the block (host operations and the card); yields a holder
    whose ``trace`` is set once the block ends."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Holder", (), {"trace": None})()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield holder
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    # the export is the profiler's stable interface; the file lives in the
    # run's temporary directory only while it is read
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    print(f"[trace] {len(events)} events, {size / 2**20:.1f} MiB of Chrome trace read",
          file=sys.stderr, flush=True)
    holder.trace = read(events)


def span(name: str):
    """A host annotation the trace reads (``Trace.annotations``)."""
    return torch.profiler.record_function(name)
