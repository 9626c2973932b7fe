"""1 - the union of the device's operation intervals over the traced
segment's host-clock length, as a share.  Source: device_trace."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0 or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
