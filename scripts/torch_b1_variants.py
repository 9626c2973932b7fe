#!/usr/bin/env python3
"""Time design variants of the port's bf16 attention kernel B1 on one GPU.

    python3 scripts/torch_b1_variants.py

Each variant is fsvid2vid_tpu_torch/csrc/flash_ref_attention_sm90.cu with a
few lines rewritten (below); all are built at once with nvcc for sm_90a into
fsvid2vid_tpu_torch/build/b1_variants/, checked to give the base kernel's
outputs bit for bit, and timed by CUDA events at the serving shape (B = 1,
hw = 16384, N = 8 x 16384, c = 128, with lf), in turns: the variants in
order, reversed, in order, reversed.  The card's SM clock and power draw are
sampled after each round.  Prints one JSON line per variant and one summary
line.  Needs a CUDA device and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# The consumers hand the tensor cores over only after their products have
# completed; "pass_early" hands over right after issuing them.
_PROLOGUE = ("""    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    turn_pass(other);""", """    wgmma_commit();
    turn_pass(other);
    wgmma_wait_all();
    fence_regs(s);""")
_LOOP = ("""      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(s);
      fence_regs(p);
      turn_pass(other);""", """      wgmma_commit();
      turn_pass(other);
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(s);
      fence_regs(p);""")
VARIANTS = {
    "base": [],
    # the two consumer warpgroups run freely instead of taking turns
    "no_pingpong": [('asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");', ""),
                    ('asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : "memory");', "")],
    "pass_early": [_PROLOGUE, _LOOP],
    # O is rescaled only when some row of the warp has a new running max
    "skip_rescale": [("  for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];",
                      "  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))\n"
                      "#pragma unroll\n"
                      "    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];")],
}
SHAPE = dict(b=1, hw=16384, n_refs=8, c=128)


def variant_source(base: str, edits) -> str:
    for old, new in edits:
        if base.count(old) != 1:
            raise ValueError(f"edit does not apply once: {old[:60]!r}")
        base = base.replace(old, new)
    return base


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_b1_variants: no CUDA device", file=sys.stderr)
        return 1
    from fsvid2vid_tpu_torch.ops import attention_kernel as ak
    from fsvid2vid_tpu_torch.ops.cuda_build import BUILD_DIR, CudaLibrary
    out_dir = BUILD_DIR / "b1_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    base = ak.KERNEL_SM90.source.read_text()
    libs = {}
    for name, edits in VARIANTS.items():
        lib = CudaLibrary(f"b1_{name}", ak._declare_sm90)
        lib.source = out_dir / f"{name}.cu"
        lib.library = out_dir / f"lib{name}.so"
        lib.source.write_text(variant_source(base, edits))
        libs[name] = (lib, lib.start_build(verbose=True))
    for name, (lib, finish) in libs.items():
        seconds, log = finish()
        print(json.dumps({"variant": name, "build_seconds": seconds, "ptxas": [
            ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln][:2]}))
    print(smi(), flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    b, hw, n_refs, c = SHAPE["b"], SHAPE["hw"], SHAPE["n_refs"], SHAPE["c"]
    scale = 2.0 / c ** 0.25        # energies with a standard deviation of ~4
    mk = lambda rows, s=1.0: (torch.randn(b, rows, c, device="cuda", generator=g)
                              * s).to(torch.bfloat16)
    q, k, xf, lf = mk(hw, scale), mk(n_refs * hw, scale), mk(n_refs * hw), mk(n_refs * hw)

    def run(name):
        out_x, out_l, vis = ak._outputs(q, lf, n_refs)
        err = libs[name][0].load().fsv_flash_ref_attention_sm90(
            q.data_ptr(), k.data_ptr(), xf.data_ptr(), lf.data_ptr(), out_x.data_ptr(),
            out_l.data_ptr(), vis.data_ptr(), b, hw, k.shape[1], c, n_refs,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant {name}: launch failed with {err}")
        return out_x, out_l, vis

    def ms(name, reps=10):
        run(name)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            run(name)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    ref = run("base")
    names = list(VARIANTS)
    for name in names[1:]:
        if any(not torch.equal(a, r) for a, r in zip(run(name), ref)):
            raise AssertionError(f"variant {name} differs from the base kernel")
    times, clocks = {n: [] for n in names}, []
    for order in (names, names[::-1], names, names[::-1]):
        for name in order:
            times[name].append(ms(name))
        clocks.append(smi())
    for name in names:
        print(json.dumps({"variant": name, "mean_ms": sum(times[name]) / len(times[name]),
                          "runs_ms": times[name]}))
    print(json.dumps({"shape": SHAPE, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(),
        "clocks_power_temperature_after_each_round": clocks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
