"""Device ms a serving step spends in the generator's flow stage (span
fsv.gen.flow: the flow networks and the warps) in the traced segment.
Source: device_trace."""
from benchmark.program_spans import device_ms_per_serve_step


def read(r):
    return device_ms_per_serve_step(r, "fsv.gen.flow")
