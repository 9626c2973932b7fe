"""Kernel B1, the K-reference attention (fsv::flash_ref_attention): the
work of one call whatever computes it (chip_smoke.py `attention_cost`,
copied).  QK^T plus one PV product per value tensor; each input read once,
each output written once, the (B, hw, K) masses written in f32."""
from __future__ import annotations


def cost(b: int, hw: int, n_refs: int, c: int, has_lf: bool, dtype_bytes: int):
    """(FLOP, bytes) of one call: query (b, hw, c); key, xf and optional lf
    (b, n_refs * hw, c)."""
    n = n_refs * hw
    n_values = 2 if has_lf else 1
    flops = 2.0 * b * hw * n * c * (1 + n_values)
    nbytes = (dtype_bytes * (b * hw * c * (1 + n_values) + b * n * c * (1 + n_values))
              + 4 * b * hw * n_refs)
    return flops, nbytes


def least_seconds(shapes, dtype_bytes: int, peaks: dict) -> float:
    """The least time of one call from the operator's input shapes as the
    profiler records them: [query, key, xf, lf (empty when absent), n_refs]."""
    (b, hw, c), (_, n, _) = shapes[0], shapes[1]
    has_lf = bool(shapes[3]) and len(shapes[3]) == 3
    flops, nbytes = cost(b, hw, n // hw, c, has_lf, dtype_bytes)
    flop_rate = peaks["bf16_flops_per_s"] if dtype_bytes == 2 else peaks["tf32_flops_per_s"]
    return max(flops / flop_rate, nbytes / peaks["bytes_per_s"])
