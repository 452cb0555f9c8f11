"""Milliseconds a frame in tracking: the mean length of the program's
``slam.track`` annotations inside the window (``GraphSLAM2D.process``'s
tracker step and the pose's read; it ends in a synchronise while traced)."""

from benchmark import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.mean_ms(ctx.trace, "slam.track")
