"""Milliseconds a tracked frame in the multi-cue step's clip: the mean length
of the program's ``tracker.multi.clip`` annotations inside the window (every
cue's projective clip of the scene and their concatenation
(``multi_step_inputs``); a child of ``slam.track``, it synchronises nothing,
so the card's share of it may fall to a later read). None where the program
has no such span."""

from benchmark import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.mean_ms(ctx.trace, "tracker.multi.clip")
