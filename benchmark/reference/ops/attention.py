"""The K > 1 reference attention in plain PyTorch: the port's
`chunked_ref_attention` (fsvid2vid_tpu_torch/ops/attention_kernel.py),
copied, which is also kernel B1's plain version.  The reference generator
runs it at eval and in train mode alike, so no kernel takes part."""
from __future__ import annotations

import torch

MAX_C = 512   # the channels up to which the port's generator takes B1 at eval


def chunked_ref_attention(query, key, xf, lf, n_refs: int, chunk_elems: int = 1 << 23):
    """A softmax over the N = n_refs·hw keys, one query chunk at a time: the
    chunk is the largest power of two (halving from hw) whose energy holds
    at most `chunk_elems` elements per sample.  query (B, hw, c), key / xf /
    lf (B, N, c), lf optional -> out_x, out_l (B, hw, c) in the dtype of xf
    / lf, vis (B, hw, n_refs) f32, each reference's share of each query's
    softmax mass.  Everything inside runs in f32 with autocast off."""
    hw, n = query.shape[1], key.shape[1]
    q_chunk = hw
    while q_chunk > 1 and n * q_chunk > chunk_elems:
        q_chunk //= 2
    with torch.autocast(query.device.type, enabled=False):
        key32, xf32 = key.float(), xf.float()
        lf32 = None if lf is None else lf.float()
        outs_x, outs_l, vis = [], [], []
        for q_c in query.float().split(q_chunk, 1):
            attn = torch.softmax(torch.bmm(q_c, key32.transpose(1, 2)), -1)  # (B, q, N)
            outs_x.append(torch.bmm(attn, xf32))
            if lf32 is not None:
                outs_l.append(torch.bmm(attn, lf32))
            vis.append(attn.unflatten(2, (n_refs, n // n_refs)).sum(3))  # (B, q, K)
        out_x = torch.cat(outs_x, 1).to(xf.dtype)
        out_l = None if lf is None else torch.cat(outs_l, 1).to(lf.dtype)
        return out_x, out_l, torch.cat(vis, 1)


def flash_ref_attention(query, key, xf, lf, n_refs: int):
    """The eval attention: the same plain softmax."""
    return chunked_ref_attention(query, key, xf, lf, n_refs)
