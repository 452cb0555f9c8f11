"""Seconds a pass in the per-message loop's closure round and its map
bookkeeping: the program's own phase times
(``GraphSLAM2D.phase_times``: ``relocalize``, ``split``, ``detect``,
``vote``, ``merge``, ``solve``; each phase ends in a synchronise while
traced), summed over the phases and averaged over the window's completed
passes."""

PHASES = ("relocalize", "split", "detect", "vote", "merge", "solve")


def read(ctx):
    passes = getattr(ctx.run, "passes", None)
    if not passes:
        return None
    return sum(sum(p["phases"].get(k, 0.0) for k in PHASES) for p in passes) / len(passes)
