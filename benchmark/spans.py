"""Arithmetic over the program's own spans in a traced run: the card's idle
time put down to the annotations open over it, and the mean length of an
annotation. Intervals are microseconds on the profiler's clock, clipped to
the window; the idle time is the complement of ``Trace.busy_intervals``."""

from __future__ import annotations


def union(spans) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out: list = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        elif e > s:
            out.append((s, e))
    return out


def intersect(a: list, b: list) -> list:
    """Intersection of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: list, b: list) -> list:
    """``a`` less ``b``, both sorted and disjoint (one pass over each)."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e and s < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if e > s:
            out.append((s, e))
    return out


def length(spans) -> float:
    return sum(e - s for s, e in spans)


def annotated(trace, name: str) -> list:
    """The union of annotation ``name``'s occurrences, clipped to the window."""
    a, b = trace.window
    return union((max(s, a), min(e, b)) for s, e in trace.annotations.get(name, [])
                 if e > a and s < b)


def idle(trace) -> list:
    """The window's idle intervals: no kernel, copy or memset on the card."""
    return subtract([trace.window], trace.busy_intervals())


# the corridor's idle, split three ways by the program's spans
FLUSH, CLOSURE = "runner.flush", "slam.closure"


def map_idle_shares(trace) -> dict | None:
    """Percent of the window the card idles inside a closure round
    (``closure``), inside a chunk's flush but outside its closure round
    (``tracking``), and with no flush open (``outside_spans``: message
    intake and the benchmark's own loop). The three sum to the window's idle
    share. None where the trace holds no flush (a program without the spans)."""
    w = trace.window[1] - trace.window[0]
    if w <= 0 or not trace.device:
        return None
    flush = annotated(trace, FLUSH)
    if not flush:
        return None
    closure = annotated(trace, CLOSURE)
    gaps = idle(trace)
    return {"closure": 100.0 * length(intersect(gaps, closure)) / w,
            "tracking": 100.0 * length(intersect(gaps, subtract(flush, closure))) / w,
            "outside_spans": 100.0 * length(subtract(gaps, union(flush + closure))) / w}


def mean_ms(trace, name: str) -> float | None:
    """Mean length of annotation ``name``'s occurrences that lie inside the
    window, in milliseconds; None where there is none."""
    a, b = trace.window
    spans = [(s, e) for s, e in trace.annotations.get(name, []) if s >= a and e <= b]
    return length(spans) / len(spans) / 1e3 if spans else None
