"""Median host-clock ms, over the traced sequence's train steps, of a
step's face discriminator (span fsv.train.face_d, summed over d_losses and
g_losses: the face crops, netDf and, for G, the crops' L1 and VGG losses),
from the port's span recorder.  Source: program_span."""
from benchmark.nested_spans import median_step_ms


def read(r):
    return median_step_ms("fsv.train.face_d")
