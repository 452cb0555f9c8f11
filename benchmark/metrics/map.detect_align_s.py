"""Seconds a pass in closure alignment: the program's own phase time
``ChunkedGraphSLAM2D.phase_times["detect.align"]`` (the span
``slam.detect.align`` around each batch's pool indexing, initial guesses,
NN-ICP launch and packing; a child of ``slam.detect``, it synchronises
nothing, so the kernel's tail falls to ``slam.detect.gate``'s read),
averaged over the window's completed passes. None where no pass holds the
key (a program without the span)."""

PHASES = ("detect.align",)


def read(ctx):
    passes = getattr(ctx.run, "passes", None)
    if not passes or not any(k in p["phases"] for p in passes for k in PHASES):
        return None
    return sum(sum(p["phases"].get(k, 0.0) for k in PHASES) for p in passes) / len(passes)
