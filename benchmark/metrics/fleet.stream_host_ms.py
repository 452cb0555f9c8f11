"""Milliseconds a call in ``ops/stream_kernel.track_streams_grid``, entry to
return, on the host and under the profiler: the mean length of the
program's ``stream.track_streams_grid`` annotations inside the window (the
tensor checks, the parameter block, the library lookup and kernel 3's
launch; the call returns before the kernel ends). The profiler records
every operation inside the call, and that recording is a large part of the
number: the same call untraced takes about half of it (``PERF.md`` gives
both). So a change to this host work is judged by the operations the
profiler records as well as by what the untraced call pays. None where the
program has no such span."""

from benchmark import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.mean_ms(ctx.trace, "stream.track_streams_grid")
