"""The served norm's share of its roofline in the traced segment: the least
time of every call of the operator fsv::norm_modulate (its bytes from
benchmark/roofline/norm_modulate.py at the call's recorded shapes, 2 bytes
an element, as the trace records no dtype: x read as f32 counts half its
bytes, so the share is a lower bound) over the device time of the kernels
launched under the operator.  Nothing to read from a program without the
operator, or from a trace without shapes.  Source: device_trace."""
OP = "fsv::norm_modulate"


def read(r):
    if r.trace is None:
        return None
    calls = [op for op in r.trace.ops(OP) if op.shapes and op.device_us > 0]
    if not calls:
        return None
    norm = r.roofline("norm_modulate")
    least = sum(norm.least_seconds(op.shapes, 2, r.peaks) for op in calls)
    return 100.0 * least / (sum(op.device_us for op in calls) / 1e6)
