"""The whole serving step's share of the card's bf16 peak over the window:
the FLOP of the reference's reset, first and later frames at the cell's
shapes (FlopCounterMode, counted in the traced run's set-up), times the
window's steps of each kind, over the window's seconds and the peak.
Source: host_clock (the window) with counted FLOP."""


def read(r):
    f = r.flops
    if not {"reset", "first", "step"} <= set(f) or not r.steps:
        return None
    total = sum(f["reset"] + f["first"] if s.kind == "reset" else f["step"]
                for s in r.steps)
    return 100.0 * total / r.window_s / r.peaks["bf16_flops_per_s"]
