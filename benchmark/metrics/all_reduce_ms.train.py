"""Device ms of NCCL's kernels (the gradient all-reduces of both updates,
the batch norms' global statistics, the losses' average) per train step
in rank 0's traced sequence of a data-parallel cell.  Source:
device_trace."""

KERNELS = ("nccl",)


def read(r):
    if r.trace is None:
        return None
    steps = r.trace.counters.get("train_steps")
    device_s = r.trace.device_seconds(KERNELS)
    if not steps or device_s <= 0:
        return None
    return 1e3 * device_s / steps
