"""Median host-clock ms of the flow teacher's call for a sequence (FlowNet2
with kernel B2), each call followed by a synchronise; taken in the traced
run's window only.  Source: host_clock."""
import statistics


def read(r):
    values = r.spans.get("teacher_ms")
    return statistics.median(values) if values else None
