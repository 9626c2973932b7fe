"""Batch x per-frame train steps completed in the window over the window's
seconds (host clock; the teacher calls in the window count)."""


def read(r):
    return r.rate() if r.steps else None
