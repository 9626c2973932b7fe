"""Median host-clock ms, over the traced sequence's train steps, of a
step's forward passes (spans fsv.train.generate, fsv.train.d_losses and
fsv.train.g_losses: G, D and VGG19 with the losses), from the port's span
recorder.  Source: program_span."""
from benchmark.program_spans import median_step_ms, program_records


def read(r):
    return median_step_ms(program_records(),
                          ["fsv.train.generate", "fsv.train.d_losses", "fsv.train.g_losses"])
