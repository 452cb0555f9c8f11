"""Seconds a pass in preprocessing: the program's own phase time
``ChunkedGraphSLAM2D.phase_times["preprocess"]`` (the span
``runner.preprocess`` around ``preprocessor.compute`` in
``ChunkedSlamRunner._flush``, which ends in a synchronise on the card while
traced), averaged over the window's completed passes. None where no pass
holds the key (a program without the span)."""

PHASES = ("preprocess",)


def read(ctx):
    passes = getattr(ctx.run, "passes", None)
    if not passes or not any(k in p["phases"] for p in passes for k in PHASES):
        return None
    return sum(sum(p["phases"].get(k, 0.0) for k in PHASES) for p in passes) / len(passes)
