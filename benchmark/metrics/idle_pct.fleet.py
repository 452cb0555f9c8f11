"""The card's idle share of the traced window, in percent."""


def read(ctx):
    if ctx.trace is None:
        return None
    idle = ctx.trace.idle_share()
    return None if idle is None else 100.0 * idle
