"""``models/fast_tracker.materialize``'s device time in a call, on the
program's own span: the kernels launched inside the ``tracker.materialize``
annotations, summed a call, mean over the calls (the arithmetic of
``fleet.materialize_ms``, which reads the benchmark's span around the same
call). None where the program has no such span."""


def read(ctx):
    if ctx.trace is None:
        return None
    groups = [g for g in ctx.trace.launched_within("tracker.materialize") if g]
    if not groups:
        return None
    return sum(sum(e - s for _, s, e, _ in g) for g in groups) / len(groups) / 1e3
