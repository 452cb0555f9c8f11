"""Milliseconds a tracked frame in the multi-cue step's merge: the mean length
of the program's ``tracker.multi.merge`` annotations inside the window (the
new pose and every cue's projective merge; a child of ``slam.track``, it
synchronises nothing, so the card's share of it may fall to a later read).
None where the program has no such span."""

from benchmark import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.mean_ms(ctx.trace, "tracker.multi.merge")
