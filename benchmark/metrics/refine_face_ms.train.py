"""Median host-clock ms, over the traced sequence's train steps, of a
step's face refinement (span fsv.train.refine_face inside generate: the
face boxes, the crops, netGf on them and the paste), from the port's span
recorder.  Source: program_span."""
from benchmark.nested_spans import median_step_ms


def read(r):
    return median_step_ms("fsv.train.refine_face")
