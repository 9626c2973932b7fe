"""Median host-clock ms, over the traced sequence's train steps, of a
step's two updates (spans fsv.train.update_D and fsv.train.update_G:
zero_grad, the backward, the all-reduce and Adam's step), from the port's
span recorder.  Source: program_span."""
from benchmark.program_spans import median_step_ms, program_records


def read(r):
    return median_step_ms(program_records(), ["fsv.train.update_D", "fsv.train.update_G"])
