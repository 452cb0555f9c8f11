"""``models/fast_tracker.materialize``'s device time in a call: the kernels
launched inside the benchmark's ``fleet.materialize`` span, summed a call,
mean over the calls."""


def read(ctx):
    if ctx.trace is None:
        return None
    groups = [g for g in ctx.trace.launched_within("fleet.materialize") if g]
    if not groups:
        return None
    return sum(sum(e - s for _, s, e, _ in g) for g in groups) / len(groups) / 1e3
