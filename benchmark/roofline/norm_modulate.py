"""The served norm's one pass (fsv::norm_modulate): the bytes of one call
whatever computes it (chip_smoke.py `check_norm_modulate`'s bound).  x read
once, each map's gamma and beta halves read once, the output written once;
the per-channel scale and shift, a few KB, are left out.  A few operations
an element: bound by bytes."""
from __future__ import annotations


def cost(n: int, n_maps: int, x_bytes: int, map_bytes: int, out_bytes: int) -> float:
    """Bytes of one call on n = B * C * H * W elements of x with `n_maps`
    maps of 2n elements each."""
    return float(n * (x_bytes + out_bytes) + n_maps * 2 * n * map_bytes)


def least_seconds(shapes, dtype_bytes: int, peaks: dict) -> float:
    """The least time of one call from the operator's input shapes as the
    profiler records them: [x, scale, shift, map0, map1, map2 (empty when
    absent), slope, out_dtype]; every tensor counted at `dtype_bytes` an
    element."""
    n = 1
    for d in shapes[0]:
        n *= d
    n_maps = sum(1 for s in shapes[3:6] if s and len(s) == 4)
    return cost(n, n_maps, dtype_bytes, dtype_bytes, dtype_bytes) / peaks["bytes_per_s"]
