"""Device ms a serving step spends in the generator's main stage (span
fsv.gen.main: the label embedding, the SPADE-combine embeddings and the
main branch) in the traced segment.  Source: device_trace."""
from benchmark.program_spans import device_ms_per_serve_step


def read(r):
    return device_ms_per_serve_step(r, "fsv.gen.main")
