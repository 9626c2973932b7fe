#!/usr/bin/env python3
"""Time source variants of the port's hand-written kernels on one GPU.

    python3 scripts/torch_kernel_variants.py [b1_bf16] [b1_f32] [b2]

A variant is a kernel's source under fsvid2vid_tpu_torch/csrc/ with a few
lines rewritten: the tables below hold (old, new) pairs, and each `old` must
occur in the source exactly once, so an edit that no longer applies stops the
script instead of timing something else.  A study (all three without
arguments) builds its base kernel and its variants at once with nvcc for
sm_90a, the variants into fsvid2vid_tpu_torch/build/variants/<study>/, and
then, for each of its cases:
  * "variants" compute the base kernel's function: B1's bit for bit, B2's
    within chip_smoke.py's CV_TOL of the plain version; the script raises
    if one does not;
  * "ablations" leave out part of the work to show what it costs or what it
    guards against; their error against the plain version is printed, not
    checked;
  * on a timed case all are timed by CUDA events in turns: in order,
    reversed, in order, reversed, with the card's SM clock, power draw and
    temperature after each round.
Prints one JSON line per build and per case, then the card's name and power
limit.  Needs a CUDA device and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# ---- B1, csrc/flash_ref_attention_sm90.cu -----------------------------------
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
      fence_p();
      turn_pass(other);""", """      wgmma_commit();
      turn_pass(other);
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(s);
      fence_p();""")
B1_BF16 = {
    "variants": {
        # the two consumer warpgroups run freely instead of taking turns
        "no_pingpong": [('asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");', ""),
                        ('asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : "memory");', "")],
        "pass_early": [_PROLOGUE, _LOOP],
        # O is rescaled only when some row of the warp has a new running max
        "skip_rescale": [("  for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];",
                          "  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))\n"
                          "#pragma unroll\n"
                          "    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];")],
    },
    "ablations": {},
}
B1_F32 = {
    "variants": {},
    "ablations": {
        # the tensor cores' own accumulators sum a whole key walk
        "no_flush": [("  static constexpr int FLUSH_TILES = 64;",
                      "  static constexpr int FLUSH_TILES = 0;")],
        # q and k in 2 bf16 parts (hi + mid): QK^T as hh, hm, mh only
        "two_part": [("return Design<T>::QP == 1 ? 5 : 0;",
                      "return Design<T>::QP == 1 ? 5 : 3;")],
    },
}

# ---- B2, csrc/cost_volume_tc.cu ---------------------------------------------
_MMA = 'asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "'
B2 = {
    "variants": {
        # one block per SM, with the registers that frees
        "one_block": [("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 1)")],
        # the split rounded to nearest by two cvt.rna.tf32 instead of truncated
        "rna_split": [("    big = __float_as_uint(x) & 0xffffe000u;\n"
                       "    small = __float_as_uint(x - __uint_as_float(big));",
                       '    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));\n'
                       '    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : '
                       '"f"(x - __uint_as_float(big)));')],
    },
    "ablations": {
        # no staging after the first step: the products run on stale buffers
        "no_stage": [("    if (step + 1 < steps) stage(step + 1);   // into the other buffer", "")],
        # f32 inputs as one tf32 product instead of three (no split)
        "no_split": [("constexpr bool SPLIT = sizeof(T) == 4;", "constexpr bool SPLIT = false;")],
        # the mma instructions left out (their operands are still loaded and split)
        "no_mma": [(_MMA, 'asm("// {%0, %1, %2, %3}, "')],
    },
}


def variant_source(base: str, edits) -> str:
    for old, new in edits:
        if base.count(old) != 1:
            raise ValueError(f"edit does not apply once: {old[:60]!r}")
        base = base.replace(old, new)
    return base


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def b1_study(torch, dtype_name):
    """B1 at chip_smoke.py's attention cases in one dtype, timed at the slice."""
    import chip_smoke as cs
    from fsvid2vid_tpu_torch.ops import attention_kernel as ak
    dtype = getattr(torch, dtype_name)
    f32 = dtype == torch.float32

    def make(case):
        shape = cs.ATTENTION_CASES[case]
        return (*cs.attention_inputs(torch, dtype=dtype, sharpness=cs.SHARPNESS.get(case, 1.0),
                                     **shape), shape["n_refs"])

    def call(lib, inputs):
        q, k, xf, lf, n_refs = inputs
        (b, hw, c), n = q.shape, k.shape[1]
        ox, ol, vis = ak._outputs(q, lf, n_refs)
        ptr = lambda t: None if t is None else t.data_ptr()
        stream = torch.cuda.current_stream().cuda_stream
        if f32:
            scratch = torch.empty(lib.fsv_flash_ref_attention_sm90_f32_scratch_bytes(
                b, hw, n, c, n_refs, int(lf is not None)), dtype=torch.uint8, device="cuda")
            err = lib.fsv_flash_ref_attention_sm90_f32(
                q.data_ptr(), k.data_ptr(), xf.data_ptr(), ptr(lf), scratch.data_ptr(),
                ox.data_ptr(), ptr(ol), vis.data_ptr(), b, hw, n, c, n_refs, stream)
        else:
            err = lib.fsv_flash_ref_attention_sm90(
                q.data_ptr(), k.data_ptr(), xf.data_ptr(), ptr(lf), ox.data_ptr(), ptr(ol),
                vis.data_ptr(), b, hw, n, c, n_refs, stream)
        if err:
            raise RuntimeError(f"launch failed with {err}")
        return ox, ol, vis

    def error(got, ref):   # (outputs, masses)
        return (max((a.float() - r.float()).abs().max().item()
                    for a, r in zip(got[:2], ref[:2]) if a is not None),
                (got[2] - ref[2]).abs().max().item())

    return dict(**(B1_F32 if f32 else B1_BF16), library=ak.KERNEL_SM90,
                declare=ak._declare_sm90, make=make, call=call, error=error,
                plain=lambda inputs: ak.flash_ref_attention_plain(*inputs),
                same=lambda got, base, ref, case: all(
                    a is None or torch.equal(a, r) for a, r in zip(got, base)),
                cases=("ragged", "short_refs", "sharp", "slice") if f32 else ("slice",),
                timed=("slice",), reps=5 if f32 else 10)


def b2_study(torch):
    """B2 at the teacher's shape, f32 and bf16, both timed."""
    import chip_smoke as cs
    from fsvid2vid_tpu_torch.ops import cost_volume as cv
    b, c, h, w, md, stride = cs.CV_SHAPES["slice"]
    d = 2 * (md // stride) + 1

    def make(case):
        g = torch.Generator(device="cuda").manual_seed(7)
        return tuple(torch.randn(b, c, h, w, device="cuda", generator=g).to(getattr(torch, case))
                     for _ in range(2))

    def call(lib, inputs):
        f1, f2 = inputs
        scratch = torch.empty(lib.fsv_cost_volume_tc_scratch_bytes(b, c, h, w),
                              dtype=torch.uint8, device="cuda")
        out = torch.empty(b, d * d, h, w, device="cuda", dtype=f1.dtype)
        err = lib.fsv_cost_volume_tc(f1.data_ptr(), f2.data_ptr(), scratch.data_ptr(),
                                     out.data_ptr(), b, c, h, w, md, stride,
                                     int(f1.dtype == torch.bfloat16),
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with {err}")
        return (out,)

    error = lambda got, ref: (got[0].float() - ref[0].float()).abs().max().item()
    return dict(**B2, library=cv.KERNEL_TC, declare=cv._declare_tc, make=make, call=call,
                error=error, plain=lambda inputs: (cv.cost_volume_plain(*inputs, md, stride),),
                same=lambda got, base, ref, case: error(got, ref) <= cs.CV_TOL[case],
                cases=("float32", "bfloat16"), timed=("float32", "bfloat16"), reps=20)


def run_study(torch, name, study):
    import chip_smoke as cs
    from fsvid2vid_tpu_torch.ops.cuda_build import BUILD_DIR, CudaLibrary
    out_dir = BUILD_DIR / "variants" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    base_source = study["library"].source.read_text()
    libs = {"base": study["library"]}
    for v, edits in {**study["variants"], **study["ablations"]}.items():
        lib = libs[v] = CudaLibrary(f"{name}_{v}", study["declare"])
        lib.source, lib.library = out_dir / f"{v}.cu", out_dir / f"lib{v}.so"
        lib.source.write_text(variant_source(base_source, edits))
    pending = {v: lib.start_build(verbose=True) for v, lib in libs.items()}
    for v, finish in pending.items():
        seconds, log = finish()
        emit({"study": name, "variant": v, "build_seconds": seconds, "ptxas": sorted({
            ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln})})
    fns = {v: (lambda inputs, lib=lib: study["call"](lib.load(), inputs))
           for v, lib in libs.items()}
    for case in study["cases"]:
        inputs = study["make"](case)
        ref = study["plain"](inputs)
        base = fns["base"](inputs)
        res = {"study": name, "case": case, "max_abs_err": {}}
        for v, fn in fns.items():
            got = fn(inputs)
            res["max_abs_err"][v] = study["error"](got, ref)
            if v in study["variants"] and not study["same"](got, base, ref, case):
                raise AssertionError(f"{name} {v} ({case}) does not compute the base "
                                     f"kernel's function: {res['max_abs_err']}")
        if case in study["timed"]:
            names = list(fns)
            times, clocks = {v: [] for v in names}, []
            for order in (names, names[::-1], names, names[::-1]):
                for v in order:
                    times[v].append(cs.cuda_ms(torch, lambda: fns[v](inputs), study["reps"]))
                clocks.append(smi("clocks.sm,power.draw,temperature.gpu"))
            res.update(mean_ms={v: sum(t) / len(t) for v, t in times.items()}, runs_ms=times,
                       clocks_power_temperature_after_each_round=clocks)
        emit(res)
        del inputs, ref, base
        torch.cuda.empty_cache()


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    studies = {"b1_bf16": lambda: b1_study(torch, "bfloat16"),
               "b1_f32": lambda: b1_study(torch, "float32"),
               "b2": lambda: b2_study(torch)}
    unknown = set(argv) - set(studies)
    if unknown:
        print(f"torch_kernel_variants: unknown studies {sorted(unknown)}; "
              f"choose from {list(studies)}", file=sys.stderr)
        return 2
    for name in argv or list(studies):
        run_study(torch, name, studies[name]())
    print(smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
