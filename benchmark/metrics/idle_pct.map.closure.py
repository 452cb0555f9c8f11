"""The card's idle share of the traced window inside a closure round (the
program's ``slam.closure`` annotations: detection, voting, merging, the
solve, relocalization), in percent. With the other two shares of
``idle_pct.map.*`` it sums to ``idle_pct.map``
(``benchmark/spans.map_idle_shares``). None where the trace holds no
``runner.flush`` (a program without the spans)."""

from benchmark import spans


def read(ctx):
    if ctx.trace is None:
        return None
    shares = spans.map_idle_shares(ctx.trace)
    return None if shares is None else shares["closure"]
