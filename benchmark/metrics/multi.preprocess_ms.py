"""Milliseconds a frame in preprocessing, both cues: the program's
``runner.preprocess`` annotations inside the window (one a cue; each ends
in a synchronise while traced) summed, over the frames the window holds
(its ``slam.track`` annotations)."""


def _inside(trace, name: str) -> list:
    a, b = trace.window
    return [(s, e) for s, e in trace.annotations.get(name, []) if s >= a and e <= b]


def read(ctx):
    if ctx.trace is None:
        return None
    frames, pre = _inside(ctx.trace, "slam.track"), _inside(ctx.trace, "runner.preprocess")
    if not frames or not pre:
        return None
    return sum(e - s for s, e in pre) / len(frames) / 1e3
