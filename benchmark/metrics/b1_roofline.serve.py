"""Kernel B1's share of its roofline in the traced segment: the least time
of every call of the operator fsv::flash_ref_attention (its work from
benchmark/roofline/b1.py at the call's recorded shapes, bf16) over the
device time of the kernels launched under the operator.  Source:
device_trace."""
OP = "fsv::flash_ref_attention"

def read(r):
    if r.trace is None:
        return None
    calls = [op for op in r.trace.ops(OP) if op.shapes and op.device_us > 0]
    if not calls:
        return None
    b1 = r.roofline("b1")
    least = sum(b1.least_seconds(op.shapes, 2, r.peaks) for op in calls)
    return 100.0 * least / (sum(op.device_us for op in calls) / 1e6)
