#!/usr/bin/env python3
"""Where a K = 3 train step's gradients part between the GPU and the CPU.

    python3 scripts/torch_k3_gradient_probe.py

Runs chip_smoke.py's `phase_small_k3_train` (a small face model's first
temporal f32 step at K = 3, on the card and on the CPU from one seed) with
the generator's chunked attention wrapped so that it records, on each
device, its outputs and the gradients that reach its outputs (out_x, out_l)
and its inputs (query, key, xf, lf).  Prints, per variant, the relative
2-norm difference card against CPU of each: as chip_smoke.py runs the phase
(the last key and query norms x4), without that sharpening, and in one query
chunk instead of four.  A gap that is as large at the attention's outputs as
at its inputs comes from the network after it, not from its backward.
Needs a CUDA device and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from fsvid2vid_tpu_torch.models import generator as gm  # noqa: E402

RECORDS: dict = {}


def recorded(real):
    def attention(query, key, xf, lf, n_refs, chunk_elems):
        outs = real(query, key, xf, lf, n_refs, chunk_elems)
        rec = RECORDS.setdefault(query.device.type, {})
        keep = lambda name: lambda g: rec.__setitem__(name, g.detach().double().cpu())
        for name, t in (("query", query), ("key", key), ("xf", xf), ("lf", lf),
                        ("out_x", outs[0]), ("out_l", outs[1])):
            if t is not None and t.requires_grad:
                t.register_hook(keep("grad_" + name))
        rec["forward"] = [o.detach().double().cpu() for o in outs if o is not None]
        return outs
    return attention


def compare(variant):
    card, cpu = RECORDS["cuda"], RECORDS["cpu"]
    rel = lambda a, b: (a - b).norm().item() / b.norm().item()
    res = {k: rel(card[k], cpu[k]) for k in card if k != "forward"}
    res["forward"] = [rel(a, b) for a, b in zip(card["forward"], cpu["forward"])]
    print(json.dumps({"variant": variant, **res}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    cs.phase_device(torch)
    cs.phase_build()
    gm.chunked_ref_attention = recorded(gm.chunked_ref_attention)
    sharpen = cs.sharpen_attention
    variants = (("as_chip_smoke_runs_it", sharpen, cs.SMALL_K3_CHUNK_ELEMS),
                ("unsharpened", lambda *args: None, cs.SMALL_K3_CHUNK_ELEMS),
                ("one_chunk", sharpen, 1 << 23))
    for name, sharpen_fn, elems in variants:
        cs.sharpen_attention, cs.SMALL_K3_CHUNK_ELEMS = sharpen_fn, elems
        try:
            cs.phase_small_k3_train(torch)
        except AssertionError as e:   # a variant may miss the phase's gates
            print(json.dumps({"variant": name, "gate": str(e)[:200]}))
        compare(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
