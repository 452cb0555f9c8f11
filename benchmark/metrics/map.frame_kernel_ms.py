"""Kernel 1's device time, mean a launch (a chunk of 1,024 frames), from the
trace by its symbol."""

SYMBOL = "frame_track_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    ks = ctx.trace.kernels(SYMBOL)
    return sum(e - s for _, s, e, _ in ks) / len(ks) / 1e3 if ks else None
