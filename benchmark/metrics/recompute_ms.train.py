"""Median host-clock ms, over the traced sequence's train steps, of remat's
re-runs in a step's backward (span fsv.train.recompute, summed over the
step: VGG19 and G's up blocks, flow nets and embedders recomputed), from
the port's span recorder; on a CUDA device the backward's thread opens the
spans, placed in a step by its interval.  Source: program_span."""
from benchmark.nested_spans import median_step_ms


def read(r):
    return median_step_ms("fsv.train.recompute")
