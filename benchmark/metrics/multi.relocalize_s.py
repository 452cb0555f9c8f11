"""Seconds a pass in the per-message loop's relocalization attempts: the
program's phase time ``relocalize`` (``GraphSLAM2D._relocalize_at_split``
before every split, ``_try_relocalize`` after an accepted closure; the
phase ends in a synchronise while traced), averaged over the window's
completed passes, as ``multi.closure_s`` reads its six phases."""


def read(ctx):
    passes = getattr(ctx.run, "passes", None)
    if not passes:
        return None
    return sum(p["phases"].get("relocalize", 0.0) for p in passes) / len(passes)
