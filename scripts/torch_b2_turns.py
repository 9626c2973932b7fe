#!/usr/bin/env python3
"""Time kernel B2's tensor-core kernel of two checkouts in turns on one GPU.

    python3 scripts/torch_b2_turns.py OTHER_CHECKOUT [CASE ...]

OTHER_CHECKOUT is another checkout of this repository (for example an
earlier commit's `fsvid2vid_tpu_torch/csrc/cost_volume_tc.cu` unpacked with
`git archive` under results/).  Its cost_volume_tc.cu and this checkout's
are built at once with nvcc for sm_90a, each into its own checkout's
fsvid2vid_tpu_torch/build/, and both are called through their C entry point
`fsv_cost_volume_tc` at chip_smoke.py's CV_SHAPES cases (by default the
three flow teachers' stride-2 shapes, the only grids a path sends), in f32
and bf16.  Each output is held against the plain version within CV_TOL;
then both are timed by CUDA events (20 launches a turn) in rounds of other,
this, this, other, with the card's SM clock, power draw and temperature
after each round.  Prints one JSON line per case and dtype, then the card's
name and power limit.  Needs a CUDA device and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

ROUNDS = 5
REPS = 20
DEFAULT_CASES = ("slice", "pose", "street")


def _declare(lib):
    fn = lib.fsv_cost_volume_tc
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.fsv_cost_volume_tc_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.fsv_cost_volume_tc_scratch_bytes.restype = ctypes.c_size_t


def library(root: Path):
    """The tc kernel of the checkout at `root`: the entry points both
    versions share."""
    from fsvid2vid_tpu_torch.ops.cuda_build import CudaLibrary
    lib = CudaLibrary("cost_volume_tc", _declare)
    lib.source = root / "fsvid2vid_tpu_torch" / "csrc" / "cost_volume_tc.cu"
    lib.library = root / "fsvid2vid_tpu_torch" / "build" / "libcost_volume_tc.so"
    return lib


def call(torch, lib, f1, f2, md, stride):
    b, c, h, w = f1.shape
    d = 2 * (md // stride) + 1
    scratch = torch.empty(lib.fsv_cost_volume_tc_scratch_bytes(b, c, h, w),
                          dtype=torch.uint8, device="cuda")
    out = torch.empty(b, d * d, h, w, device="cuda", dtype=f1.dtype)
    err = lib.fsv_cost_volume_tc(f1.data_ptr(), f2.data_ptr(), scratch.data_ptr(),
                                 out.data_ptr(), b, c, h, w, md, stride,
                                 int(f1.dtype == torch.bfloat16),
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fsv_cost_volume_tc failed with CUDA error {err}")
    return out


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def main(argv) -> int:
    import torch
    import chip_smoke as cs
    from fsvid2vid_tpu_torch.ops import cost_volume as cv
    if not torch.cuda.is_available():
        print("torch_b2_turns: no CUDA device", file=sys.stderr)
        return 1
    other_root = Path(argv[0]).resolve()
    cases = argv[1:] or DEFAULT_CASES
    libs = {"other": library(other_root), "this": library(REPO)}
    pending = [(name, lib.start_build()) for name, lib in libs.items()]
    for name, finish in pending:
        seconds, _ = finish()
        print(json.dumps({"build": name, "source": str(libs[name].source),
                          "seconds": seconds}), flush=True)
    loaded = {name: lib.load() for name, lib in libs.items()}
    for case in cases:
        b, c, h, w, md, stride = cs.CV_SHAPES[case]
        for dtype_name in ("float32", "bfloat16"):
            g = torch.Generator(device="cuda").manual_seed(7)
            f1, f2 = (torch.randn(b, c, h, w, device="cuda", generator=g)
                      .to(getattr(torch, dtype_name)) for _ in range(2))
            ref = cv.cost_volume_plain(f1, f2, md, stride).float()
            errs = {name: (call(torch, lib, f1, f2, md, stride).float() - ref)
                    .abs().max().item() for name, lib in loaded.items()}
            del ref
            if max(errs.values()) > cs.CV_TOL[dtype_name]:
                raise AssertionError(f"{case} {dtype_name}: errors {errs} above "
                                     f"{cs.CV_TOL[dtype_name]}")
            turns, clocks = {"other": [], "this": []}, []
            for _ in range(ROUNDS):
                for name in ("other", "this", "this", "other"):
                    turns[name].append(cs.cuda_ms(
                        torch, lambda lib=loaded[name]: call(torch, lib, f1, f2, md, stride),
                        REPS))
                clocks.append(smi("clocks.sm,power.draw,temperature.gpu"))
            mean = {name: sum(ms) / len(ms) for name, ms in turns.items()}
            print(json.dumps({"case": case, "dtype": dtype_name, "shape": [b, c, h, w, md, stride],
                              "max_abs_err": errs, "turns_ms": turns, "mean_ms": mean,
                              "this_over_other": mean["this"] / mean["other"],
                              "sm_clock_power_temperature": clocks}), flush=True)
    print(smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
