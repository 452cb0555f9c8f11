"""Seconds a pass in tracking (track and materialize): the program's own phase times
(``ChunkedGraphSLAM2D.phase_times``, each phase ending in a synchronise on
the card), summed over the phases and averaged over the window's completed
passes."""

PHASES = ("track", "materialize",)


def read(ctx):
    passes = getattr(ctx.run, "passes", None)
    if not passes:
        return None
    return sum(sum(p["phases"].get(k, 0.0) for k in PHASES) for p in passes) / len(passes)
