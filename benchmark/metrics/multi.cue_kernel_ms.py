"""Kernel 6's device time, mean a launch (one multi-cue frame), from the
trace by its symbol; ``multicue_block_sums_kernel`` is added where it
launches (it does not on the tracker's path)."""

SYMBOLS = ("multicue_align_kernel", "multicue_block_sums_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    launches = ctx.trace.kernels(SYMBOLS[0])
    if not launches:
        return None
    total = sum(e - s for sym in SYMBOLS for _, s, e, _ in ctx.trace.kernels(sym))
    return total / len(launches) / 1e3
