"""Kernel 3's share of its roofline: the least time its frozen count needs
on the card's published peaks over its mean device time a launch."""

from benchmark.counts import bound_s
from benchmark.counts import stream_kernel as count

SYMBOL = "stream_track_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    ks = ctx.trace.kernels(SYMBOL)
    if not ks:
        return None
    mean_s = sum(e - s for _, s, e, _ in ks) / len(ks) / 1e6
    i = ctx.run.info
    need = bound_s(count.launch_bytes(i["T"], i["K"], i["B"]),
                   count.launch_flops(i["T"], i["K"], i["B"], i["iterations"],
                                      i["corr_refresh"]))
    return 100.0 * need / mean_s
