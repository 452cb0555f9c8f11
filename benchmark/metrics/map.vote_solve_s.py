"""Seconds a pass in the validator's partition solves: the program's own
phase time ``ChunkedGraphSLAM2D.phase_times["vote.solve"]`` (the span
``slam.vote.solve`` around each partition's graph, ``pgo.optimize`` and the
read of its poses; a child of ``slam.vote``, it synchronises nothing),
averaged over the window's completed passes. None where no pass holds the
key (a program without the span)."""

PHASES = ("vote.solve",)


def read(ctx):
    passes = getattr(ctx.run, "passes", None)
    if not passes or not any(k in p["phases"] for p in passes for k in PHASES):
        return None
    return sum(sum(p["phases"].get(k, 0.0) for k in PHASES) for p in passes) / len(passes)
