"""Frames of every stream completed in the window over the window's
seconds (host clock; clip resets in the window count)."""


def read(r):
    return r.rate() if r.steps else None
