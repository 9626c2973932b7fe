"""95th percentile, over every step of the window, of the time from the
step's call (with its reset at a clip's start) to all its frames on the
host (host clock)."""
from benchmark.readings import p95


def read(r):
    return p95(r.latencies_ms()) if len(r.steps) > 1 else None
