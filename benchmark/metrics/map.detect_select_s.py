"""Seconds a pass in closure candidate selection: the program's own phase
time ``ChunkedGraphSLAM2D.phase_times["detect.select"]`` (the span
``slam.detect.select`` around ``select_many``'s breadth-first search on the
host; a child of ``slam.detect``, it synchronises nothing), averaged over
the window's completed passes. None where no pass holds the key (a program
without the span)."""

PHASES = ("detect.select",)


def read(ctx):
    passes = getattr(ctx.run, "passes", None)
    if not passes or not any(k in p["phases"] for p in passes for k in PHASES):
        return None
    return sum(sum(p["phases"].get(k, 0.0) for k in PHASES) for p in passes) / len(passes)
