"""The card's idle share of the traced window inside a chunk's flush
(``runner.flush``) but outside its closure round: preprocessing, kernel 1,
the stats read, the graph rebuild and the scenes, in percent. With the other
two shares of ``idle_pct.map.*`` it sums to ``idle_pct.map``
(``benchmark/spans.map_idle_shares``). None where the trace holds no
``runner.flush`` (a program without the spans)."""

from benchmark import spans


def read(ctx):
    if ctx.trace is None:
        return None
    shares = spans.map_idle_shares(ctx.trace)
    return None if shares is None else shares["tracking"]
