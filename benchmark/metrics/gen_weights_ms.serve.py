"""Device ms a serving step spends in the generator's weight generation
(span fsv.gen.weights: the references' encoding, the attention with kernel
B1, the generated SPADE weights) in the traced segment; at K = 1 the step
reuses the reset's cache and runs none.  Source: device_trace."""
from benchmark.program_spans import device_ms_per_serve_step


def read(r):
    return device_ms_per_serve_step(r, "fsv.gen.weights")
