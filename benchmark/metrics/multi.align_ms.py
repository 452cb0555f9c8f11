"""Milliseconds a tracked frame in the multi-cue step's align: the mean
length of the program's ``tracker.multi.align`` annotations inside the
window (kernel 6's call, or ``icp.align_multi`` on the CPU; a child of
``slam.track``, it synchronises nothing, so the card's share of it may fall
to a later read). None where the program has no such span."""

from benchmark import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.mean_ms(ctx.trace, "tracker.multi.align")
