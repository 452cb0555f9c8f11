"""Kernel 6's launches a tracked multi-cue frame over the window: the
program's counters ``ops/multicue_align_kernel.launches`` (card launches)
over ``models/tracker.multi_frames`` (tracked frames, either route), read
at the window's start and end. 1.0 on the card's route. None where the
program has no such counters or tracked nothing."""


def read(ctx):
    c0, c1 = ctx.run.counters.get("start", {}), ctx.run.counters.get("end", {})
    keys = ("launches", "multi_frames")
    if any(c0.get(k) is None or c1.get(k) is None for k in keys):
        return None
    frames = c1["multi_frames"] - c0["multi_frames"]
    return (c1["launches"] - c0["launches"]) / frames if frames > 0 else None
