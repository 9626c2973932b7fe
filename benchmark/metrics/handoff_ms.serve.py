"""Device ms a serving step spends handing its frames to the host (span
fsv.serve.handoff, the last child of fsv.serve.step: the copy of the
frames into page-locked host memory) in the traced segment.  Source:
device_trace."""
from benchmark.program_spans import device_ms_per_serve_step


def read(r):
    return device_ms_per_serve_step(r, "fsv.serve.handoff")
