"""Kernel B2's share of its roofline in the traced segment: the least time
of every B2 launch (its work from benchmark/roofline/b2.py at the launch's
recorded shape) over the device time of B2's kernels.  B2 is launched
through ctypes with no registered operator, so its kernels are found by
the __global__ names of fsvid2vid_tpu_torch/csrc/cost_volume*.cu.  Source:
device_trace."""

KERNELS = ("cost_volume_tc_kernel", "to_channels_last_kernel", "cost_volume_kernel")


def read(r):
    if r.trace is None:
        return None
    calls = r.trace.counters.get("b2_calls")
    device_s = r.trace.device_seconds(KERNELS)
    if not calls or device_s <= 0:
        return None
    b2 = r.roofline("b2")
    least = sum(b2.least_seconds(*shape, md, stride, nbytes, r.peaks)
                for shape, md, stride, nbytes in calls)
    return 100.0 * least / device_s
