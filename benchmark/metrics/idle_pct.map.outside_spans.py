"""The card's idle share of the traced window with no ``runner.flush`` open:
message intake and the benchmark's own loop, in percent. With the other two
shares of ``idle_pct.map.*`` it sums to ``idle_pct.map``
(``benchmark/spans.map_idle_shares``). None where the trace holds no
``runner.flush`` (a program without the spans)."""

from benchmark import spans


def read(ctx):
    if ctx.trace is None:
        return None
    shares = spans.map_idle_shares(ctx.trace)
    return None if shares is None else shares["outside_spans"]
