"""Kernel B2, FlowNetC's correlation cost volume: the work of one call
whatever computes it (chip_smoke.py `check_cost_volume`'s bound, copied).
Only the (pixel, shift) pairs whose shifted pixel lies inside the map need
a product; the others are zero by definition.  Each input read once, the
output written once."""
from __future__ import annotations


def displacements(max_displacement: int, stride: int):
    d = max_displacement // stride
    return [(dy * stride, dx * stride)
            for dy in range(-d, d + 1) for dx in range(-d, d + 1)]


def cost(b: int, c: int, h: int, w: int, md: int, stride: int, dtype_bytes: int):
    """(FLOP of the useful products, bytes) of one call on f1, f2 (b, c, h, w)."""
    d = 2 * (md // stride) + 1
    flops = 2.0 * b * c * sum(max(0, h - abs(dy)) * max(0, w - abs(dx))
                              for dy, dx in displacements(md, stride))
    nbytes = (2.0 * b * c * h * w + d * d * b * h * w) * dtype_bytes
    return flops, nbytes


def least_seconds(b, c, h, w, md, stride, dtype_bytes: int, peaks: dict) -> float:
    """At the peak of the arithmetic that keeps the dtype's accuracy on the
    tensor cores: bf16 products for bf16; three TF32 products per useful
    f32 one (3xTF32)."""
    flops, nbytes = cost(b, c, h, w, md, stride, dtype_bytes)
    if dtype_bytes == 2:
        ops_s = flops / peaks["bf16_flops_per_s"]
    else:
        ops_s = 3 * flops / peaks["tf32_flops_per_s"]
    return max(ops_s, nbytes / peaks["bytes_per_s"])
