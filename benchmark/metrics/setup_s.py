"""Process start to the window's start: building, weights, warm-up and, in
a checkout's first run, the kernels' build (host clock)."""


def read(r):
    return r.setup_s
