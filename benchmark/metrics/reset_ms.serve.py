"""Median host-clock ms of `InferencePipeline.reset` (the references'
encoding at a clip's start), ending in a synchronise; taken in the traced
run's window only, where each reset is followed by one.  Source:
host_clock."""
import statistics


def read(r):
    values = r.spans.get("reset_ms")
    return statistics.median(values) if values else None
