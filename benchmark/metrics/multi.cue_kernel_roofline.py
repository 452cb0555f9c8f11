"""Kernel 6's share of its roofline: the least time its frozen count needs
on the card's published peaks, for the mean launch of the window (moving
and fixed rows from the program's counters ``moving_rows`` and
``fixed_rows`` over ``launches``, read at the window's start and end), over
its mean device time a launch. None where the program has no such counters
or launched nothing."""

from benchmark.counts import bound_s
from benchmark.counts import multicue_kernel as count

SYMBOL = "multicue_align_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    ks = ctx.trace.kernels(SYMBOL)
    c0, c1 = ctx.run.counters.get("start", {}), ctx.run.counters.get("end", {})
    keys = ("launches", "moving_rows", "fixed_rows")
    if not ks or any(c0.get(k) is None or c1.get(k) is None for k in keys):
        return None
    n = c1["launches"] - c0["launches"]
    if n <= 0:
        return None
    moving = (c1["moving_rows"] - c0["moving_rows"]) / n
    fixed = (c1["fixed_rows"] - c0["fixed_rows"]) / n
    i = ctx.run.info
    need = bound_s(count.launch_bytes(i["cues"], fixed, moving, i["iterations"]),
                   count.launch_flops(i["cues"], moving, i["iterations"]))
    mean_s = sum(e - s for _, s, e, _ in ks) / len(ks) / 1e6
    return 100.0 * need / mean_s
