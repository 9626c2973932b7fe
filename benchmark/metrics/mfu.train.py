"""The whole training step's share of the card's bf16 peak over the window:
the FLOP of a sequence on the reference (its teacher call, its first
frame's train step and T - 1 later ones: forward and backward of G, D and
VGG19, both updates) at the cell's shapes (FlopCounterMode, counted in the
traced run's set-up), times the window's sequences, over the window's
seconds and the peak.  Source: host_clock (the window) with counted FLOP."""


def read(r):
    if "sequence" not in r.flops or not r.steps:
        return None
    return 100.0 * r.flops["sequence"] * len(r.steps) / r.window_s / r.peaks["bf16_flops_per_s"]
