"""Median host-clock ms of a frame's train step (span fsv.train.step) over
the traced sequence's steps, from the port's span recorder.  Source:
program_span."""
from benchmark.program_spans import TRAIN_STEP, median_step_ms, program_records


def read(r):
    return median_step_ms(program_records(), [TRAIN_STEP])
