#!/usr/bin/env python3
"""Smoke test of the PyTorch port (fsvid2vid_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, all at
once (one nvcc per source): multi-reference flash attention on three routes
(the bf16 tensor-core kernel, the f32 tensor-core kernel on split-bf16
products, and the CUDA-core kernel that keeps c % 8 != 0) and the FlowNetC
cost volume on two (the banded tensor-core product for stride 2, the
CUDA-core kernel for other grids).  It holds each against its plain PyTorch
version on the card, times each tensor-core kernel in turns against the
CUDA-core design it replaced, and then drives the port's two main paths end
to end at the full width of face_config:

  * serving: K-shot face synthesis at 512 px with K = 8 references (the
    attention kernel once per frame: bf16 frames on the bf16 tensor-core
    route, f32 frames on the f32 one), and the K = 1 face-256 forward;
  * training: face 256 px at batch 4 with seeded random G, D, VGG19 and
    FlowNet2; the flow teacher (the tensor-core cost volume once per flow
    call), then single-frame and temporal steps of `train_step` and
    `train_step_faithful` in bf16, two steps in f32, and a small model's
    step on the card against the CPU.

Each phase prints one JSON line; the kernels line comes before the last
line, and the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

The serving slice's line also holds a torch.profiler breakdown of one warm
K = 8 frame per dtype, the training slice's one of a temporal bf16 step and
of a teacher call.  Any failure raises and exits non-zero.  Without a CUDA device, or without
the fsvid2vid_tpu_torch package next to this file, it exits non-zero before
printing any result.  It imports nothing of JAX or of fsvid2vid_tpu.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM data sheet, dense, at the 700 W power limit
H100_BF16_FLOPS = 989e12   # tensor cores
H100_TF32_FLOPS = 495e12   # tensor cores
H100_F32_FLOPS = 67e12     # outside the tensor cores
H100_BYTES_PER_S = 3.35e12

# the attention at face 512 px, K = 8, n_downsample_A = 2 (B=1, hw=128^2)
SLICE = dict(b=1, hw=128 * 128, n_refs=8, c=128, has_lf=True)
RAGGED = dict(b=2, hw=13 * 11, n_refs=3, c=40, has_lf=False)
# c % 8 != 0: the CUDA-core kernel's route in both dtypes
RAGGED_C36 = dict(b=1, hw=150, n_refs=3, c=36, has_lf=True)
# hw_key = 40 < 64 keys per tile: every tile of the tensor-core kernel is a
# masked reference tail
SHORT_REFS = dict(b=1, hw=40, n_refs=5, c=64, has_lf=True)
# energies with a standard deviation of ~16 instead of ~4, so the running max
# moves a lot within a reference
SHARP = dict(b=1, hw=2048, n_refs=4, c=128, has_lf=True)
SHARPNESS = {"sharp": 4.0}
# kernel vs plain version, max abs error on outputs / on the masses:
#  ragged, f32: the same f32 math in another order: 1e-4 / 1e-5 (the CPU
#    tests' tolerances);
#  slice, f32: every f32 accumulator sums N = 131072 keys in sequence, so
#    rounding grows to ~sqrt(N) * 6e-8 ~ 2e-5 relative on outputs of up to
#    ~5: 5e-4 / 1e-4 (one PyTorch attention call differs from the plain
#    version by the same order);
#  sharp, f32: energies of std ~16 (|s| up to ~70); the exponential turns
#    an energy's absolute error into the weight's relative error, so here a
#    split of q and k into 2 bf16 parts (16 bits) errs ~10x more than the
#    f32 kernel's 3 (24 bits): the limit lies between the two, 1.5e-4 /
#    2.5e-5 (PERF.md §6 has the readings of both on the card);
#  bf16: the kernel rounds p to bf16 before the value products (as the TPU
#    kernel does) and both round the outputs to bf16: 3e-2 / 1e-4.
TOL = {("slice", "float32"): (5e-4, 1e-4), ("sharp", "float32"): (1.5e-4, 2.5e-5),
       **{(case, "float32"): (1e-4, 1e-5)
          for case in ("ragged", "ragged_c36", "short_refs")},
       **{(case, "bfloat16"): (3e-2, 1e-4)
          for case in ("ragged", "ragged_c36", "slice", "short_refs", "sharp")}}
ATTENTION_CASES = {"slice": SLICE, "ragged": RAGGED, "ragged_c36": RAGGED_C36,
                   "short_refs": SHORT_REFS, "sharp": SHARP}
# a tensor-core kernel timed in turns against the CUDA-core design it replaced
TIMING_TURNS = {"bfloat16": ("sm90", "cuda_core", "cuda_core", "sm90"),
                "float32": ("sm90_f32", "cuda_core", "cuda_core", "sm90_f32")}
# K = 8 slice, f32 frames with the kernel vs with the plain attention: the
# attention outputs differ by <= 5e-4 (above); through the decoder: 2e-3
SLICE_FRAME_TOL = 2e-3
# small K = 3 model, card (kernel) vs CPU (plain version), f32 frames
SMALL_FRAME_TOL = 1e-4
N_FRAMES = 4


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build():
    """One nvcc per source, all started together; ptxas's register and spill
    counts per kernel instantiation."""
    import re
    from fsvid2vid_tpu_torch.ops import attention_kernel as ak
    from fsvid2vid_tpu_torch.ops import cost_volume as cv
    t0 = time.perf_counter()
    pending = [(lib, lib.start_build(verbose=True))
               for lib in (ak.KERNEL_SM90, ak.KERNEL, cv.KERNEL_TC, cv.KERNEL)]
    for lib, finish in pending:
        seconds, log = finish()
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "setmaxnreg" in ln]
        registers = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", log)]
        emit({"phase": "build", "kernel": lib.name,
              "source": str(lib.source.relative_to(REPO)), "seconds": seconds,
              "registers": registers, "spill_store_bytes": spills,
              "ptxas": ptxas[:12], "ptxas_lines": len(ptxas)})
    emit({"phase": "build", "all_seconds": time.perf_counter() - t0})


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_inputs(torch, b, hw, n_refs, c, has_lf, dtype, seed=0, sharpness=1.0):
    """Seeded inputs whose energies have a standard deviation of
    ~4 * sharpness, so the softmax is neither one-hot nor flat."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = n_refs * hw
    scale = 2.0 * sharpness ** 0.5 / c ** 0.25

    def mk(rows, s=1.0):
        return (torch.randn(b, rows, c, device="cuda", generator=g) * s).to(dtype)
    return mk(hw, scale), mk(n, scale), mk(n), mk(n) if has_lf else None


def attention_cost(b, hw, n_refs, c, has_lf, dtype_bytes):
    """FLOP and bytes of one call: QK^T plus one PV product per value
    tensor; each input read once, each output written once.  Also the FLOP
    of the f32 tensor-core kernel's split products: 6 bf16 products for
    QK^T and 3 per value tensor."""
    n = n_refs * hw
    n_values = 2 if has_lf else 1
    unit = 2.0 * b * hw * n * c
    flops = unit * (1 + n_values)
    nbytes = (dtype_bytes * (b * hw * c * (1 + n_values) + b * n * c * (1 + n_values))
              + 4 * b * hw * n_refs)
    return flops, nbytes, unit * (6 + 3 * n_values)


def library_attention(torch, q, k, xf, lf, n_refs):
    """Yardstick, never called by the port: one scaled_dot_product_attention
    whose values are [xf | lf | one-hot(reference)], so one call yields
    out_x, out_l and vis."""
    import torch.nn.functional as F
    b, n, _ = k.shape
    onehot = F.one_hot(torch.arange(n, device=k.device) // (n // n_refs),
                       n_refs).to(k.dtype)
    v = torch.cat([xf] + ([lf] if lf is not None else [])
                  + [onehot.expand(b, n, n_refs)], dim=-1)
    return lambda: F.scaled_dot_product_attention(q[:, None], k[:, None],
                                                  v[:, None], scale=1.0)


def check_kernel(torch, dtype_name, case, timed):
    """The routed kernel against the plain version on one seeded input; the
    route follows from the dtype and c (ops/attention_kernel.py route_for)."""
    from fsvid2vid_tpu_torch.ops import attention_kernel as ak
    dtype = getattr(torch, dtype_name)
    shape = ATTENTION_CASES[case]
    n_refs = shape["n_refs"]
    route = ak.route_for("cuda", dtype, shape["c"])
    q, k, xf, lf = attention_inputs(torch, dtype=dtype,
                                    sharpness=SHARPNESS.get(case, 1.0), **shape)
    before = dict(ak.flash_ref_attention.launches_by_route)
    ox, ol, vis = ak.flash_ref_attention(q, k, xf, lf, n_refs)
    torch.cuda.synchronize()
    moved = {r: n - before[r] for r, n in ak.flash_ref_attention.launches_by_route.items()}
    if moved != {r: int(r == route) for r in moved}:
        raise AssertionError(f"flash_ref_attention {case} {dtype_name}: launches by "
                             f"route {moved}, expected one on {route}")
    px, pl_, pvis = ak.flash_ref_attention_plain(q, k, xf, lf, n_refs)
    torch.cuda.synchronize()
    for name, t in (("out_x", ox), ("out_l", ol), ("vis", vis)):
        if t is not None and not torch.isfinite(t).all():
            raise AssertionError(f"kernel {name} not finite ({case}, {dtype_name})")
    err_out = (ox.float() - px.float()).abs().max().item()
    if lf is not None:
        err_out = max(err_out, (ol.float() - pl_.float()).abs().max().item())
    err_vis = (vis - pvis).abs().max().item()
    tol_out, tol_vis = TOL[case, dtype_name]
    ok = err_out <= tol_out and err_vis <= tol_vis
    res = {"phase": "kernel_check", "kernel": "flash_ref_attention", "route": route,
           "case": case, "dtype": dtype_name, "shape": shape,
           "sharpness": SHARPNESS.get(case, 1.0),
           "max_abs_err_out": err_out, "tol_out": tol_out,
           "max_abs_err_vis": err_vis, "tol_vis": tol_vis, "ok": ok}
    if timed and ok:   # in turns against the CUDA-core design it replaced
        launch = {"sm90": ak._launch_sm90, "sm90_f32": ak._launch_sm90_f32,
                  "cuda_core": ak._launch_cuda_core}
        turns = [(r, cuda_ms(torch, lambda r=r: launch[r](q, k, xf, lf, n_refs), 5))
                 for r in TIMING_TURNS[dtype_name]]
        mean = lambda name: sum(ms for r, ms in turns if r == name) / 2
        res["turns_ms"] = turns
        res["sm_clock_power_temperature"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
        res["ms"] = mean(route)
        res["previous_design_ms"] = mean("cuda_core")
        res["plain_ms"] = cuda_ms(
            torch, lambda: ak.flash_ref_attention_plain(q, k, xf, lf, n_refs), 2)
        lib = library_attention(torch, q, k, xf, lf, n_refs)
        out = lib()
        res["library_max_abs_err_vis"] = (out[:, 0, :, -n_refs:].float()
                                          - pvis).abs().max().item()
        del out
        res["library_ms"] = cuda_ms(torch, lib, 5)
        flops, nbytes, split_flops = attention_cost(
            shape["b"], shape["hw"], n_refs, shape["c"], shape["has_lf"], q.element_size())
        # the bound of the operations the kernel does, at the peak for their
        # type: bf16 products (the f32 kernel's are its split products); for
        # f32 also the useful f32 work at the CUDA cores' f32 peak
        ops_ms = 1e3 * (split_flops if route == "sm90_f32" else flops) / H100_BF16_FLOPS
        bytes_ms = 1e3 * nbytes / H100_BYTES_PER_S
        res.update(flop=flops, bytes=nbytes, bound_ms=max(ops_ms, bytes_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        if route == "sm90_f32":
            res.update(split_flop=split_flops,
                       f32_cuda_core_bound_ms=1e3 * flops / H100_F32_FLOPS)
        res["bound_share"] = res["bound_ms"] / res["ms"]
        res["tflops"] = flops / res["ms"] / 1e9
    emit(res)
    if not ok:
        raise AssertionError(f"flash_ref_attention {case} {dtype_name}: error "
                             f"{err_out}/{err_vis} above {tol_out}/{tol_vis}")
    return res


def phase_kernels(torch):
    """Every case in both dtypes; the slice timed.  The c = 36 case keeps the
    CUDA-core kernel launched and checked."""
    res = {(case, d): check_kernel(torch, d, case, case == "slice")
           for case in ATTENTION_CASES for d in ("bfloat16", "float32")}
    if {r["route"] for (case, _), r in res.items() if case == "ragged_c36"} != {"cuda_core"}:
        raise AssertionError("the c = 36 cases did not take the CUDA-core route")
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# the cost-volume kernel
# ----------------------------------------------------------------------
# (B, C, H, W, max_displacement, stride): the teacher's call on a 3-frame
# sequence of batch 4 at 256 px; the same net at 512 px; a ragged shape; a
# stride-1 grid, which only the CUDA-core kernel takes
CV_SHAPES = {"slice": (12, 256, 32, 32, 20, 2), "px512": (4, 256, 64, 64, 20, 2),
             "ragged": (2, 40, 13, 19, 4, 2), "stride1": (2, 40, 13, 19, 4, 1)}
# kernel vs plain version, max abs error.  Both sum <= 256 f32 products of
# N(0, 1) inputs and divide by C, so |out| < 1:
#  f32: the same products summed in another order: 2e-6;
#  bf16: both round an f32 result below 1 to bf16 (ulp 2^-8 below 1, and the
#    two f32 sums may fall on either side of a rounding boundary): 4e-3.
CV_TOL = {"float32": 2e-6, "bfloat16": 4e-3}
# the tensor-core kernel timed in turns against the CUDA-core design
CV_TIMING_TURNS = ("tc", "cuda_core", "cuda_core", "tc")


def cv_tc_flops(b, c, h, w, md, split):
    """FLOP of the tc kernel's own tf32 products (csrc/cost_volume_tc.cu):
    per output row, each vertical shift whose row lies in the map, each
    32-pixel chunk and each parity, a 16 x 8 NT product over C padded to 32;
    three times over for f32 inputs (3xTF32)."""
    d = 2 * (md // 2) + 1
    r = d - 1
    shifts = sum(sum(0 <= y - r + 2 * i < h for i in range(d)) for y in range(h))
    n_tiles = (15 + d + 7) // 8
    per = 2 * 16 * 8 * n_tiles * (-(-c // 32) * 32) * 2 * -(-w // 32)
    return float(b * shifts * per * (3 if split else 1))


def check_cost_volume(torch, dtype_name, case):
    """The routed kernel against the plain version; on the tc route the
    CUDA-core kernel too, both timed in turns."""
    from fsvid2vid_tpu_torch.ops import cost_volume as cv
    b, c, h, w, md, stride = CV_SHAPES[case]
    dtype = getattr(torch, dtype_name)
    route = cv.route_for("cuda", md, stride)
    g = torch.Generator(device="cuda").manual_seed(7)
    f1 = torch.randn(b, c, h, w, device="cuda", generator=g).to(dtype)
    f2 = torch.randn(b, c, h, w, device="cuda", generator=g).to(dtype)
    before = dict(cv.cost_volume_cuda.launches_by_route)
    out = cv.correlation(f1, f2, md, stride)
    torch.cuda.synchronize()
    moved = {r: n - before[r] for r, n in cv.cost_volume_cuda.launches_by_route.items()}
    if moved != {r: int(r == route) for r in moved}:
        raise AssertionError(f"cost_volume {case} {dtype_name}: launches by route "
                             f"{moved}, expected one on {route}")
    ref = cv.cost_volume_plain(f1, f2, md, stride)
    d = 2 * (md // stride) + 1
    if out.shape != (b, d * d, h, w) or out.dtype != dtype:
        raise AssertionError(f"cost volume output {tuple(out.shape)} {out.dtype}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"cost volume not finite ({case}, {dtype_name})")
    err = (out.float() - ref.float()).abs().max().item()
    tol = CV_TOL[dtype_name]
    flops = 2.0 * b * h * w * d * d * c
    nbytes = (2.0 * b * c * h * w + d * d * b * h * w) * f1.element_size()
    # the useful products at the peak of the arithmetic that keeps the
    # dtype's accuracy: bf16 products for bf16; for f32 on the tensor cores
    # three tf32 products per useful one (3xTF32; six split-bf16 products at
    # the bf16 peak take as long), on the CUDA cores f32 FMAs
    if dtype == torch.bfloat16:
        ops_s = flops / H100_BF16_FLOPS
    elif route == "tc":
        ops_s = 3 * flops / H100_TF32_FLOPS
    else:
        ops_s = flops / H100_F32_FLOPS
    res = {"phase": "kernel_check", "kernel": "cost_volume", "route": route, "case": case,
           "dtype": dtype_name, "shape": CV_SHAPES[case], "max_abs_err": err,
           "tol": tol, "ok": err <= tol, "out_abs_max": ref.float().abs().max().item(),
           "plain_ms": cuda_ms(torch, lambda: cv.cost_volume_plain(f1, f2, md, stride), 3),
           "flop": flops, "bytes": nbytes,
           "bound_ms": 1e3 * max(ops_s, nbytes / H100_BYTES_PER_S),
           "bound_by": "operations" if ops_s >= nbytes / H100_BYTES_PER_S else "bytes",
           "library_ms": None}   # no single PyTorch call computes this function
    if dtype == torch.float32:
        res["f32_cuda_core_bound_ms"] = 1e3 * max(flops / H100_F32_FLOPS,
                                                  nbytes / H100_BYTES_PER_S)
    if route == "tc":
        old = cv._launch_cuda_core(f1, f2, md, stride)
        res["cuda_core_max_abs_err"] = (old.float() - ref.float()).abs().max().item()
        res["ok"] = res["ok"] and res["cuda_core_max_abs_err"] <= tol
        del old
        launch = {"tc": cv._launch_tc, "cuda_core": cv._launch_cuda_core}
        turns = [(r, cuda_ms(torch, lambda r=r: launch[r](f1, f2, md, stride), 20))
                 for r in CV_TIMING_TURNS]
        res["turns_ms"] = turns
        res["ms"] = sum(ms for r, ms in turns if r == "tc") / 2
        res["previous_design_ms"] = sum(ms for r, ms in turns if r == "cuda_core") / 2
        tc_flops = cv_tc_flops(b, c, h, w, md, dtype == torch.float32)
        res.update(tc_flop=tc_flops, design_bound_ms=1e3 * tc_flops / H100_TF32_FLOPS)
        res["design_bound_share"] = res["design_bound_ms"] / res["ms"]
    else:
        res["ms"] = cuda_ms(torch, lambda: cv.cost_volume_cuda(f1, f2, md, stride), 20)
    res["bound_share"] = res["bound_ms"] / res["ms"]
    emit(res)
    if not res["ok"]:
        raise AssertionError(f"cost_volume {case} {dtype_name}: error {err} above {tol}")
    return res


def phase_cost_volume(torch):
    res = {(case, d): check_cost_volume(torch, d, case)
           for case in CV_SHAPES for d in ("float32", "bfloat16")}
    if res["stride1", "float32"]["route"] != "cuda_core":
        raise AssertionError("the stride-1 grid did not take the CUDA-core route")
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# the serving path
# ----------------------------------------------------------------------
def seeded_inputs(torch, cfg, k, t, seed):
    """Labels (T, 1, H, W, 1), references (1, K, H, W, *) on the card; the
    driving labels are reference 1's label plus noise."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h, w, cl = cfg.height, cfg.width, cfg.gen_input_nc
    ref_labels = torch.randn(1, k, h, w, cl, device="cuda", generator=g)
    ref_images = torch.tanh(torch.randn(1, k, h, w, 3, device="cuda", generator=g))
    fav = min(1, k - 1)
    labels = ref_labels[None, :, fav] + 0.1 * torch.randn(
        t, 1, h, w, cl, device="cuda", generator=g)
    return labels, ref_labels, ref_images


def build(torch, cfg, seed, device="cuda"):
    """Seeded generator with random running statistics.  For K > 1 the last
    key and query norms are scaled by 4 (energies x 16), so that the
    attention has a clear favourite: at random init the K masses are nearly
    tied and the argmax would be left to rounding."""
    from fsvid2vid_tpu_torch.models import build_generator
    from fsvid2vid_tpu_torch.models.layers import SyncBatchNorm
    gen = torch.Generator().manual_seed(seed)
    g = build_generator(cfg, device=device, generator=gen)
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, SyncBatchNorm):
                n = m.running_mean.shape[0]
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
        if cfg.n_shot > 1:
            for kind in ("key", "query"):
                getattr(g, f"atn_{kind}_{cfg.n_downsample_A - 1}").bn.weight.mul_(4)
    return g


def run_frames(torch, pipe, labels, ref_labels, ref_images):
    """reset + one step per label, twice: the first pass warms up (cuDNN's
    algorithm choice, allocator); per-frame ms of the second pass, on the
    host clock around work that ends in a synchronise."""
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.reset(ref_labels, ref_images, labels[0])
        torch.cuda.synchronize()
        reset_ms = 1e3 * (time.perf_counter() - t0)
        frames, ms, ref_idx = [], [], []
        for label in labels:
            t0 = time.perf_counter()
            out = pipe.step(label)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            frames.append(out["fake_image"])
            ref_idx.append(None if out["ref_idx"] is None else out["ref_idx"].tolist())
    frames = torch.stack(frames)
    if not torch.isfinite(frames).all():
        raise AssertionError("non-finite frames")
    return frames, ms, reset_ms, ref_idx


def profile_step(torch, pipe, label, find=None):
    return profile_call(torch, lambda: pipe.step(label), find)


def profile_call(torch, fn, find=None):
    """Device time of one warm call of `fn` by kernel (torch.profiler's
    CUDA kernel records; CUPTI's own buffer records left out): the 10
    largest, their sum, the call's host-clock ms, and with `find` the ms and
    launches of the kernels whose name holds that string."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cupti_records = {"Activity Buffer Request", "Buffer Flush", "Command Buffer Full"}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel = {}
    for e in prof.events():
        # device-side annotations (the optimizer's step range) are not kernels
        if (e.device_type == DeviceType.CUDA and e.name not in cupti_records
                and not e.name.startswith("Optimizer.")):
            ms, n = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    device_ms = sum(ms for ms, _ in by_kernel.values())
    res = {"step_ms": step_ms, "device_ms": device_ms,
           "device_busy_share": device_ms / step_ms, "kernel_launches":
           sum(n for _, n in by_kernel.values()),
           "top": [{"kernel": k[:90], "ms": ms, "calls": n} for k, (ms, n) in rows[:10]]}
    if find is not None:
        found = [(ms, n) for k, (ms, n) in by_kernel.items() if find in k]
        res.update(found=find, found_ms=sum(ms for ms, _ in found),
                   found_launches=sum(n for _, n in found))
    return res


def phase_slice(torch):
    """K = 8 at 512 px, full-width face_config: bf16 frames, then f32."""
    from fsvid2vid_tpu_torch.config import face_config
    from fsvid2vid_tpu_torch.inference.pipeline import InferencePipeline
    from fsvid2vid_tpu_torch.ops import attention_kernel as ak
    # init_variance 1: activations of order one, so the attention is decisive
    cfg = face_config(fine_size=512, load_size=512, n_shot=8, batch_size=1,
                      is_train=False, init_variance=1.0)
    g = build(torch, cfg, seed=0)
    labels, ref_labels, ref_images = seeded_inputs(torch, cfg, 8, N_FRAMES, seed=1)
    res = {"phase": "slice_k8_512", "ngf": cfg.ngf, "n_downsample_G": cfg.n_downsample_G,
           "n_adaptive_layers": cfg.n_adaptive_layers, "nff": cfg.nff,
           "n_blocks_F": cfg.n_blocks_F, "n_shot": cfg.n_shot, "size": cfg.fine_size,
           "frames_per_dtype": 2 * N_FRAMES}
    counts = ak.flash_ref_attention.launches_by_route
    ak.flash_ref_attention.launches = 0
    for route in counts:
        counts[route] = 0
    out, by_dtype = {}, {}
    for dtype in ("bfloat16", "float32"):
        before = dict(counts)
        pipe = InferencePipeline(cfg, g, compute_dtype=dtype)
        out[dtype] = run_frames(torch, pipe, labels, ref_labels, ref_images)
        by_dtype[dtype] = {r: counts[r] - before[r] for r in counts}
    launches = ak.flash_ref_attention.launches
    res.update(launches=launches, launches_by_route=dict(counts),
               launches_by_dtype=by_dtype)
    for dtype, (frames, ms, reset_ms, ref_idx) in out.items():
        res[dtype] = {"frame_ms": ms, "reset_ms": reset_ms, "ref_idx": ref_idx,
                      "frame_std": frames.std().item()}
    if launches != 4 * N_FRAMES:
        raise AssertionError(f"kernel launches {launches} != frames {4 * N_FRAMES}")
    # each dtype's frames on its own tensor-core route only
    want = {"bfloat16": {"sm90": 2 * N_FRAMES, "sm90_f32": 0, "cuda_core": 0},
            "float32": {"sm90": 0, "sm90_f32": 2 * N_FRAMES, "cuda_core": 0}}
    if by_dtype != want:
        raise AssertionError(f"launches by dtype and route {by_dtype} != {want}")
    for dtype in ("bfloat16", "float32"):   # one warm frame with warp_prev
        pipe = InferencePipeline(cfg, g, compute_dtype=dtype)
        pipe.reset(ref_labels, ref_images, labels[0])
        pipe.step(labels[0])
        name = {"bfloat16": "flash_ref_attention_sm90_kernel<__nv_bfloat16",
                "float32": "flash_ref_attention_sm90_kernel<float"}[dtype]
        prof = res[f"profile_{dtype}"] = profile_step(torch, pipe, labels[1], find=name)
        if prof["found_launches"] != 1:
            raise AssertionError(f"the {dtype} frame's profile shows "
                                 f"{prof['found_launches']} launches of {name}, not 1")

    # the same f32 pipeline with the plain attention, on the card
    g.attention = ak.flash_ref_attention_plain
    plain = run_frames(torch, InferencePipeline(cfg, g), labels, ref_labels, ref_images)
    g.attention = ak.flash_ref_attention
    res["plain_f32"] = {"frame_ms": plain[1], "ref_idx": plain[3]}
    err = (out["float32"][0] - plain[0]).abs().max().item()
    res.update(f32_vs_plain_max_abs_err=err, tol=SLICE_FRAME_TOL)
    bf_err = (out["bfloat16"][0] - out["float32"][0]).abs().max().item()
    res["bf16_vs_f32_max_abs_err"] = bf_err
    emit(res)
    if out["float32"][3] != plain[3]:
        raise AssertionError(f"ref_idx differs: {out['float32'][3]} vs {plain[3]}")
    if err > SLICE_FRAME_TOL:
        raise AssertionError(f"K=8 frames: kernel vs plain {err} > {SLICE_FRAME_TOL}")
    del g
    torch.cuda.empty_cache()
    return res


def phase_small(torch):
    """Small K = 3 model: the card (kernel) against the CPU (plain)."""
    from fsvid2vid_tpu_torch.config import face_config
    from fsvid2vid_tpu_torch.inference.pipeline import run_sequence
    cfg = face_config(ngf=8, nff=8, fine_size=64, load_size=64, n_blocks_F=2,
                      n_shot=3, batch_size=1, is_train=False, init_variance=1.0)
    labels, ref_labels, ref_images = seeded_inputs(torch, cfg, 3, 3, seed=2)
    frames = {}
    for device in ("cuda", "cpu"):
        g = build(torch, cfg, seed=5, device=device)
        frames[device] = run_sequence(cfg, g, labels.cpu(), ref_labels.cpu(),
                                      ref_images.cpu()).cpu()
    err = (frames["cuda"] - frames["cpu"]).abs().max().item()
    emit({"phase": "small_k3_card_vs_cpu", "max_abs_err": err, "tol": SMALL_FRAME_TOL,
          "frame_std": frames["cpu"].std().item()})
    if not err <= SMALL_FRAME_TOL:
        raise AssertionError(f"card vs CPU {err} > {SMALL_FRAME_TOL}")


def phase_k1(torch):
    """K = 1 at 256 px, full-width face_config (the flagship forward)."""
    from fsvid2vid_tpu_torch.config import face_config
    from fsvid2vid_tpu_torch.inference.pipeline import run_sequence
    from fsvid2vid_tpu_torch.ops import attention_kernel as ak
    cfg = face_config(batch_size=1, is_train=False, init_variance=1.0)
    g = build(torch, cfg, seed=3)
    labels, ref_labels, ref_images = seeded_inputs(torch, cfg, 1, N_FRAMES, seed=4)
    ak.flash_ref_attention.launches = 0
    res = {"phase": "k1_256", "size": cfg.fine_size, "frames": N_FRAMES}
    for dtype in ("bfloat16", "float32"):
        for rep in range(2):   # the first run includes cuDNN's algorithm search
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = run_sequence(cfg, g, labels, ref_labels, ref_images,
                                  compute_dtype=dtype)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / N_FRAMES
        if frames.shape != (N_FRAMES, 1, cfg.height, cfg.width, 3):
            raise AssertionError(f"K=1 frames shape {tuple(frames.shape)}")
        if not torch.isfinite(frames).all():
            raise AssertionError("K=1 frames not finite")
        res[dtype] = {"ms_per_frame": ms, "frame_std": frames.std().item()}
    res["launches"] = ak.flash_ref_attention.launches
    emit(res)


# ----------------------------------------------------------------------
# the training path
# ----------------------------------------------------------------------
TRAIN_BATCH = 4
TEMPORAL_FRAMES = 3
# small model, one f32 step: the card (B2 kernel in the teacher) vs the CPU
SMALL_STEP_RTOL = 1e-3


def train_data(torch, cfg, b, t, seed, device="cuda"):
    """A seeded batch of sequences: labels and images (B, T, H, W, C), one
    reference (B, 1, H, W, C); frame t is frame 0 shifted by t pixels plus
    noise, so consecutive frames are related."""
    g = torch.Generator().manual_seed(seed)
    h, w, cl = cfg.height, cfg.width, cfg.gen_input_nc
    import torch.nn.functional as F
    smooth = lambda c: F.interpolate(torch.randn(b, c, h // 8, (w + 8 * t) // 8, generator=g),
                                     scale_factor=8, mode="bilinear")
    base_l, base_i = smooth(cl), smooth(3)
    frames = lambda base, c: torch.stack(
        [base[..., i:i + w] + 0.05 * torch.randn(b, c, h, w, generator=g)
         for i in range(t)], 1).movedim(2, -1)
    seq = dict(tgt_label=frames(base_l, cl), tgt_image=torch.tanh(frames(base_i, 3)),
               ref_labels=smooth(cl)[..., :w].movedim(1, -1)[:, None],
               ref_images=torch.tanh(smooth(3)[..., :w]).movedim(1, -1)[:, None])
    return {k: v.contiguous().to(device) for k, v in seq.items()}


def run_train_sequence(torch, cfg, state, teacher, step_fn, seq, epoch, dtype,
                       log, profile=False):
    """What the trainer does with one batch of sequences: one teacher call,
    then one step per frame.  Returns the number of flow computations."""
    from fsvid2vid_tpu_torch.training.step import StepFlags, init_prevs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flow_gt, conf_gt = teacher(cfg, seq, epoch)
    torch.cuda.synchronize()
    teacher_ms = 1e3 * (time.perf_counter() - t0)
    flow_calls = sum(f is not None for f in flow_gt)
    for f, c in zip(flow_gt, conf_gt):
        if f is not None and not (torch.isfinite(f).all() and torch.isfinite(c).all()):
            raise AssertionError("teacher output not finite")
    temporal = epoch > cfg.niter_single
    n_frames = seq["tgt_label"].shape[1]
    entry = {"step": step_fn.__name__, "dtype": dtype, "temporal": temporal,
             "frames": n_frames, "teacher_ms": teacher_ms, "flow_calls": flow_calls,
             "conf_mean": [None if c is None else c.mean().item() for c in conf_gt],
             "step_ms": [], "losses": []}
    prevs = None
    for t in range(n_frames):
        at = lambda xs: [None if x is None else x[:, t] for x in xs]
        batch = dict(tgt_label=seq["tgt_label"][:, t], tgt_image=seq["tgt_image"][:, t],
                     ref_labels=seq["ref_labels"], ref_images=seq["ref_images"],
                     flow_gt=at(flow_gt), conf_gt=at(conf_gt))
        if prevs is None:
            prevs = init_prevs(cfg, batch)
        flags = StepFlags(warp_prev=temporal, has_prev=t > 0)
        run = lambda: step_fn(cfg, state, batch, prevs, flags, compute_dtype=dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profile and t == n_frames - 1:
            box = {}
            entry["profile_step"] = profile_call(torch, lambda: box.update(out=run()))
            prevs, losses, _ = box["out"]
        else:
            prevs, losses, _ = run()
        torch.cuda.synchronize()
        entry["step_ms"].append(1e3 * (time.perf_counter() - t0))
        losses = {k: v.item() for k, v in losses.items()}
        bad = [k for k, v in losses.items() if v != v or abs(v) == float("inf")]
        if bad:
            raise AssertionError(f"non-finite losses {bad} ({entry['step']}, {dtype})")
        entry["losses"].append(losses)
    if profile:
        entry["profile_teacher"] = profile_call(torch, lambda: teacher(cfg, seq, epoch))
        flow_calls += sum(f is not None for f in flow_gt)
    entry["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log.append(entry)
    return flow_calls


def phase_train(torch):
    """Face 256 px, batch 4, full width: the teacher and both train steps."""
    from fsvid2vid_tpu_torch.config import face_config
    from fsvid2vid_tpu_torch.ops import cost_volume as cv
    from fsvid2vid_tpu_torch.training.flow_teacher import FlowTeacher
    from fsvid2vid_tpu_torch.training.state import TrainState, build_models
    from fsvid2vid_tpu_torch.training.step import train_step, train_step_faithful
    cfg = face_config(batch_size=TRAIN_BATCH)
    gen = torch.Generator().manual_seed(11)
    t0 = time.perf_counter()
    models = build_models(cfg, generator=gen)
    teacher = FlowTeacher(cfg, generator=gen)
    state = TrainState(cfg, models)
    torch.cuda.synchronize()
    count = lambda m: sum(p.numel() for p in m.parameters())
    res = {"phase": "train_face_256", "size": cfg.fine_size, "batch": TRAIN_BATCH,
           "ngf": cfg.ngf, "n_downsample_G": cfg.n_downsample_G,
           "n_adaptive_layers": cfg.n_adaptive_layers, "ndf": cfg.ndf,
           "num_D": cfg.num_D, "n_layers_D": cfg.n_layers_D, "n_frames_G": cfg.n_frames_G,
           "params": {"G": count(models.netG), "D": count(models.netD),
                      "DT": count(models.netDT), "vgg": count(models.vgg),
                      "flownet2": count(teacher.model)},
           "build_seconds": time.perf_counter() - t0}
    single = [train_data(torch, cfg, TRAIN_BATCH, 1, seed) for seed in (21, 22)]
    temporal = train_data(torch, cfg, TRAIN_BATCH, TEMPORAL_FRAMES, 23)
    before = {n: [p.detach().clone() for p in m.parameters()]
              for n, m in (("G", models.netG), ("D", models.netD))}
    torch.cuda.reset_peak_memory_stats()
    cv.cost_volume_cuda.launches = 0
    for route in cv.cost_volume_cuda.launches_by_route:
        cv.cost_volume_cuda.launches_by_route[route] = 0
    log, flow_calls = [], 0
    e_single, e_temporal = 1, cfg.niter_single + 1
    for step_fn in (train_step, train_step_faithful):
        for seq in single:
            flow_calls += run_train_sequence(torch, cfg, state, teacher, step_fn, seq,
                                             e_single, "bfloat16", log)
        flow_calls += run_train_sequence(torch, cfg, state, teacher, step_fn, temporal,
                                         e_temporal, "bfloat16", log,
                                         profile=step_fn is train_step)
    for seq in single:
        flow_calls += run_train_sequence(torch, cfg, state, teacher, train_step, seq,
                                         e_single, "float32", log)
    launches = cv.cost_volume_cuda.launches
    by_route = dict(cv.cost_volume_cuda.launches_by_route)
    res.update(sequences=log, steps=state.step, flow_calls=flow_calls,
               cost_volume_launches=launches, cost_volume_launches_by_route=by_route)
    moved = {}
    for n, m in (("G", models.netG), ("D", models.netD)):
        params = list(m.parameters())
        if not all(torch.isfinite(p).all() for p in params):
            raise AssertionError(f"non-finite parameters in {n}")
        moved[n] = sum(int(not torch.equal(p, q)) for p, q in zip(params, before[n]))
        moved[n + "_of"] = len(params)
    res["tensors_moved"] = moved
    emit(res)
    if launches != flow_calls or launches == 0:
        raise AssertionError(f"cost volume launches {launches} != flow calls {flow_calls}")
    if by_route != {"tc": flow_calls, "cuda_core": 0}:
        raise AssertionError(f"cost volume launches by route {by_route}: expected every "
                             "teacher call on the tensor-core route")
    if moved["G"] < 0.9 * moved["G_of"] or moved["D"] < 0.9 * moved["D_of"]:
        raise AssertionError(f"parameters did not move: {moved}")
    del models, teacher, state, before
    torch.cuda.empty_cache()
    return res


def phase_small_train(torch):
    """A small model's first f32 train step, teacher included, on the card
    (B2 kernel) against the CPU (plain version), from the same seed."""
    from fsvid2vid_tpu_torch.config import face_config
    from fsvid2vid_tpu_torch.training.flow_teacher import FlowTeacher
    from fsvid2vid_tpu_torch.training.state import TrainState, build_models
    from fsvid2vid_tpu_torch.training.step import StepFlags, init_prevs, train_step
    cfg = face_config(ngf=8, nff=8, ndf=8, fine_size=64, load_size=64, n_blocks_F=2,
                      n_downsample_G=3, n_adaptive_layers=2, batch_size=2, niter_single=0)
    losses, conf = {}, {}
    for device in ("cuda", "cpu"):
        gen = torch.Generator().manual_seed(31)
        state = TrainState(cfg, build_models(cfg, device=device, generator=gen))
        teacher = FlowTeacher(cfg, device=device, generator=gen)
        seq = train_data(torch, cfg, 2, 2, 32, device=device)
        flow_gt, conf_gt = teacher(cfg, seq, epoch=1)
        conf[device] = [c.mean().item() for c in conf_gt]
        at = lambda xs: [x[:, 1] for x in xs]
        batch = dict(tgt_label=seq["tgt_label"][:, 1], tgt_image=seq["tgt_image"][:, 1],
                     ref_labels=seq["ref_labels"], ref_images=seq["ref_images"],
                     flow_gt=at(flow_gt), conf_gt=at(conf_gt))
        prevs = dict(label=seq["tgt_label"][:, 0], real=seq["tgt_image"][:, 0],
                     fake=seq["tgt_image"][:, 0])
        _, out, _ = train_step(cfg, state, batch, prevs, StepFlags(True, True))
        losses[device] = {k: v.item() for k, v in out.items()}
    rel = {k: abs(v - losses["cpu"][k]) / max(abs(losses["cpu"][k]), 1e-6)
           for k, v in losses["cuda"].items()}
    emit({"phase": "small_train_card_vs_cpu", "losses_cuda": losses["cuda"],
          "losses_cpu": losses["cpu"], "conf_mean": conf, "max_rel_err": max(rel.values()),
          "tol": SMALL_STEP_RTOL})
    if not max(rel.values()) <= SMALL_STEP_RTOL:
        raise AssertionError(f"small train step, card vs CPU: {rel}")


# ----------------------------------------------------------------------
# the training and inference CLIs
# ----------------------------------------------------------------------
CLI_SEQS, CLI_FRAMES, CLI_IMAGE = 2, 12, 512
CLI_STEPS = 3           # sequences per epoch
CLI_TURN_SEQS = 12      # sequences per timing turn
CLI_TURNS = ("loader", "loaded", "loaded", "loader")
CLI_TEST_FRAMES = 8


def face_keypoints(np, rng, size, jitter=1.5):
    """68 landmarks in a face layout (jaw, brows, nose, eyes, mouth) inside
    a size x size image, with a little noise."""
    s = size / 128.0
    t = np.linspace(0.15 * np.pi, 0.85 * np.pi, 17)
    kp = np.zeros((68, 2))
    kp[:17] = np.stack([64 - 38 * np.cos(t), 52 + 42 * np.sin(t)], 1)
    kp[17:22] = np.stack([np.linspace(36, 58, 5), [44, 41, 40, 41, 43]], 1)
    kp[22:27] = np.stack([np.linspace(70, 92, 5), [43, 41, 40, 41, 44]], 1)
    kp[27:31] = np.stack([[64] * 4, np.linspace(50, 68, 4)], 1)
    kp[31:36] = np.stack([np.linspace(56, 72, 5), [72, 74, 75, 74, 72]], 1)
    ring = np.linspace(np.pi, 3 * np.pi, 7)[:6]
    for first, cx in ((36, 46), (42, 82)):
        kp[first:first + 6] = np.stack([cx + 8 * np.cos(ring), 52 + 3 * np.sin(ring)], 1)
    m = np.linspace(0, 2 * np.pi, 13)[:12]
    kp[48:60] = np.stack([64 - 16 * np.cos(m), 86 + 6 * np.sin(m)], 1)
    m = np.linspace(0, 2 * np.pi, 9)[:8]
    kp[60:68] = np.stack([64 - 10 * np.cos(m), 86 + 3 * np.sin(m)], 1)
    return (kp + rng.uniform(-jitter, jitter, kp.shape)) * s


def write_face_dataset(root, seed):
    """The face dataset layout (train_/test_ keypoints as 68 x 2 CSV, images
    as JPEG) with CLI_SEQS sequences of CLI_FRAMES frames of CLI_IMAGE px:
    smooth seeded images, keypoints that drift from frame to frame."""
    import os
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(seed)
    for seq in range(CLI_SEQS):
        name = f"{seq + 1:04d}"
        for sub in ("train_keypoints", "train_images", "test_keypoints", "test_images"):
            os.makedirs(os.path.join(root, sub, name), exist_ok=True)
        base = face_keypoints(np, rng, CLI_IMAGE)
        for f in range(CLI_FRAMES):
            kp = base + rng.uniform(-2, 2, base.shape) + f
            small = rng.randint(0, 255, (CLI_IMAGE // 16, CLI_IMAGE // 16, 3), np.uint8)
            img = Image.fromarray(small).resize((CLI_IMAGE, CLI_IMAGE), Image.BICUBIC)
            for kind in ("train", "test"):
                np.savetxt(os.path.join(root, f"{kind}_keypoints", name, f"{f:05d}.txt"),
                           kp, delimiter=",")
                img.save(os.path.join(root, f"{kind}_images", name, f"{f:05d}.jpg"),
                         quality=90)
    return root


def zero_counts(cv):
    cv.cost_volume_cuda.launches = 0
    for route in cv.cost_volume_cuda.launches_by_route:
        cv.cost_volume_cuda.launches_by_route[route] = 0


def check_counts(cv, what, expected):
    """Every cost-volume launch since zero_counts on the tensor-core route,
    as many as the run's flow computations."""
    by_route = dict(cv.cost_volume_cuda.launches_by_route)
    if by_route != {"tc": expected, "cuda_core": 0}:
        raise AssertionError(f"{what}: cost volume launches by route {by_route}, "
                             f"expected {expected} on the tensor-core route")
    return by_route


def trained_tensors(trainer):
    """Networks' state and both Adam states of a trainer, by name."""
    out = {}
    for key in ("netG", "netD", "netDT"):
        for name, t in getattr(trainer.models, key).state_dict().items():
            out[f"{key}.{name}"] = t
    for key in ("opt_G", "opt_D"):
        for i, moments in getattr(trainer.state, key).state_dict()["state"].items():
            for m, t in moments.items():
                out[f"{key}.{i}.{m}"] = t
    return out


def sequence_times(timings):
    return [{"epoch": t["epoch"], "iter": t["iter"], "frames": t["frames"],
             "wait_ms": t["wait_ms"], "seq_ms": t["ms"], "ms_per_step": t["ms"] / t["frames"]}
            for t in timings]


def profile_host(fn, top=8):
    """One call of `fn` on this thread under cProfile: its ms, and the
    functions with the most time of their own."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(fn)
    ms = 1e3 * (time.perf_counter() - t0)
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {"ms": ms, "top_own_ms": [
        {"function": f"{fn_[0].rsplit('/', 1)[-1]}:{fn_[1]}:{fn_[2]}", "calls": st[1],
         "own_ms": 1e3 * st[2], "cumulative_ms": 1e3 * st[3]} for fn_, st in rows]}


def phase_cli(torch):
    """The user's entry points at full face-256 width, batch 4, bf16, on a
    seeded synthetic face dataset of 512 px JPEGs: `cli.train.main` for one
    single-frame and one temporal epoch (the loader on its worker threads,
    VGG19 and the FlowNet2 teacher on, kernel B2 once per flow computation),
    a resume with --continue_train for a third epoch, turns that time the
    same batches with the loader's threads working and already loaded,
    the checkpoint's size and its save and restore times, then `cli.test`
    for CLI_TEST_FRAMES frames from `latest`."""
    import math
    import os
    import tempfile
    import warnings
    from fsvid2vid_tpu_torch.cli import test as cli_test
    from fsvid2vid_tpu_torch.cli import train as cli_train
    from fsvid2vid_tpu_torch.data.loader import SequenceLoader
    from fsvid2vid_tpu_torch.ops import cost_volume as cv
    from fsvid2vid_tpu_torch.training import checkpoint as ckpt
    from fsvid2vid_tpu_torch.training.trainer import to_device
    res = {"phase": "cli_train_face_256"}
    # the rasteriser's quadratic fits of near-vertical three-point edges
    warnings.filterwarnings("ignore", message="Polyfit may be poorly conditioned")
    with tempfile.TemporaryDirectory(prefix="fsv_cli_") as tmp:
        t0 = time.perf_counter()
        data = write_face_dataset(os.path.join(tmp, "data"), seed=41)
        res["dataset"] = {"sequences": CLI_SEQS, "frames": CLI_FRAMES, "px": CLI_IMAGE,
                          "seconds": time.perf_counter() - t0}
        ckpts = os.path.join(tmp, "checkpoints")
        argv = ["--name", "cli", "--dataroot", data, "--checkpoints_dir", ckpts,
                "--batchSize", "4", "--niter", "2", "--niter_single", "1",
                "--niter_decay", "0", "--steps_per_epoch", str(CLI_STEPS),
                "--save_epoch_freq", "1000", "--print_freq", "4", "--display_freq", "4"]

        # ---- train: epoch 1 single-frame, epoch 2 temporal (2 frames) ----
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(cv)
        t0 = time.perf_counter()
        run = cli_train.main(argv)
        torch.cuda.synchronize()
        res["train_seconds"] = time.perf_counter() - t0
        res["launches_train"] = check_counts(cv, "cli train", CLI_STEPS * 1 + CLI_STEPS * 2)
        cfg, trainer = run.cfg, run.trainer
        res["config"] = {k: getattr(cfg, k) for k in (
            "fine_size", "batch_size", "ngf", "n_downsample_G", "n_adaptive_layers", "ndf",
            "num_workers", "compute_dtype", "no_vgg_loss", "no_flow_gt", "step_mode")}
        run_dir = os.path.join(ckpts, "cli")
        for name in ("loss_log.txt", "latest", os.path.join("web", "index.html")):
            if not os.path.exists(os.path.join(run_dir, name)):
                raise AssertionError(f"cli train wrote no {name}")
        res["epoch_losses"] = trainer.epoch_metrics
        bad = [(e, k) for e, m in trainer.epoch_metrics.items() for k, v in m.items()
               if not math.isfinite(v)]
        if sorted(trainer.epoch_metrics) != [1, 2] or bad:
            raise AssertionError(f"cli train epochs {sorted(trainer.epoch_metrics)}, "
                                 f"non-finite losses {bad}")
        res["sequences"] = sequence_times(trainer.timings)

        # ---- resume at epoch 3 with the saved state, then finish it ----
        saved = {k: v.clone() for k, v in trained_tensors(trainer).items()}
        del run, trainer
        torch.cuda.empty_cache()
        parser = cli_train.build_arg_parser()
        zero_counts(cv)
        resumed = cli_train.setup(parser.parse_args(
            argv + ["--continue_train", "--niter", "3"]), parser)
        trainer = resumed.trainer
        if (trainer.start_epoch, trainer.epoch_iter) != (3, 0):
            raise AssertionError(f"resumed at {(trainer.start_epoch, trainer.epoch_iter)}")
        got = trained_tensors(trainer)
        differ = [k for k, v in saved.items() if k not in got or not torch.equal(got[k], v)]
        if differ or len(got) != len(saved):
            raise AssertionError(f"resumed state differs from the saved one: {differ[:5]}")
        res["resume"] = {"start_epoch": trainer.start_epoch, "tensors_equal": len(saved)}
        del saved
        trainer.fit(resumed.make_data_iter, resumed.teacher)
        resumed.vis.close()
        res["resume"]["launches"] = check_counts(cv, "cli resume", CLI_STEPS * 2)
        if sorted(trainer.epoch_metrics) != [3] or not all(
                math.isfinite(v) for v in trainer.epoch_metrics[3].values()):
            raise AssertionError(f"resumed epoch: {trainer.epoch_metrics}")
        res["resume"]["sequences"] = sequence_times(trainer.timings)

        # ---- the loader's threads against batches already loaded ----
        loader = SequenceLoader(cfg, steps_per_epoch=CLI_TURN_SEQS, seed=cfg.seed)
        loader.set_epoch_frames(2)
        t0 = time.perf_counter()
        loaded = list(loader.epoch(3))
        res["loader_alone_ms_per_batch"] = 1e3 * (time.perf_counter() - t0) / CLI_TURN_SEQS
        res["loader_batch_profile"] = profile_host(
            lambda: loader._batch(loader.dataset, 3, 0))
        turns = []
        for turn in CLI_TURNS:
            n0 = len(trainer.timings)
            trainer.train_epoch(3, loader.epoch(3) if turn == "loader" else iter(loaded),
                                resumed.teacher)
            times = sequence_times(trainer.timings[n0:])
            turns.append({"turn": turn, "ms_per_step": [t["ms_per_step"] for t in times],
                          "wait_ms": [t["wait_ms"] for t in times]})
        mean = lambda kind: (sum(sum(t["ms_per_step"]) for t in turns if t["turn"] == kind)
                             / sum(len(t["ms_per_step"]) for t in turns if t["turn"] == kind))
        res["turns"] = turns
        res["turn_workers"] = loader.num_workers
        res["ms_per_step_loader"], res["ms_per_step_loaded"] = mean("loader"), mean("loaded")
        res["loader_cost_share"] = res["ms_per_step_loader"] / res["ms_per_step_loaded"] - 1

        # ---- one teacher call on a loaded 2-frame batch ----
        seq = to_device(loaded[0], resumed.device)
        teacher_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resumed.teacher(cfg, seq, 3)
            torch.cuda.synchronize()
            teacher_ms.append(1e3 * (time.perf_counter() - t0))
        res["teacher_ms"] = teacher_ms

        # ---- the checkpoint: bytes, save and restore seconds ----
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ckpt.save(cfg, trainer.state, 4)
        res["checkpoint_save_seconds"] = time.perf_counter() - t0
        res["checkpoint_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        ckpt.restore(cfg, trainer.state)
        torch.cuda.synchronize()
        res["checkpoint_restore_seconds"] = time.perf_counter() - t0
        res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del resumed, trainer, loaded, seq
        torch.cuda.empty_cache()

        # ---- inference from latest ----
        t0 = time.perf_counter()
        web = cli_test.main([
            "--name", "cli", "--dataroot", data, "--checkpoints_dir", ckpts,
            "--results_dir", os.path.join(tmp, "results"), "--how_many", str(CLI_TEST_FRAMES),
            "--seq_path", os.path.join(data, "test_images", "0001/"),
            "--ref_img_path", os.path.join(data, "test_images", "0002/")])
        res["test_seconds"] = time.perf_counter() - t0
        images = os.listdir(os.path.join(web, "images"))
        res["test_images"] = {kind: sum(kind in i for i in images)
                              for kind in ("synthesized", "input_label", "ref_flow")}
        if res["test_images"]["synthesized"] != CLI_TEST_FRAMES:
            raise AssertionError(f"cli test wrote {res['test_images']}")
    emit(res)
    torch.cuda.empty_cache()
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "fsvid2vid_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: fsvid2vid_tpu_torch not found next to this file",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    smi = phase_device(torch)
    phase_build()
    kern = phase_kernels(torch)
    cv_res = phase_cost_volume(torch)
    slice_res = phase_slice(torch)
    phase_small(torch)
    phase_k1(torch)
    train_res = phase_train(torch)
    phase_small_train(torch)
    cli_res = phase_cli(torch)
    bf, f32 = kern["slice", "bfloat16"], kern["slice", "float32"]
    c36 = kern["ragged_c36", "float32"]
    routes = slice_res["launches_by_route"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "previous_design_ms",
            "bound_share")
    b1 = {"route": "cuda", "replaces": "fsvid2vid_tpu/ops/pallas/attention_kernel.py:158",
          "shape": SLICE, "card": smi}
    # the CUDA-core design both tensor-core routes replaced at the slice: its
    # f32 FMAs bound at the f32 peak; on the main path no more, checked at c = 36
    b1_cuda_core = {
        "name": "flash_ref_attention_cuda_core", **b1,
        "source": "fsvid2vid_tpu_torch/csrc/flash_ref_attention.cu",
        "launches": routes["cuda_core"], "checked_on": "ragged_c36",
        "max_abs_err": c36["max_abs_err_out"], "ms": f32["previous_design_ms"],
        "plain_ms": f32["plain_ms"], "bound_ms": f32["f32_cuda_core_bound_ms"],
        "bound_by": "operations", "library_ms": f32["library_ms"], "dtype": "float32"}
    cv_main = cv_res["slice", "float32"]   # the teacher runs in f32
    cv_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    b2 = {"route": "cuda", "replaces": "fsvid2vid_tpu/ops/pallas/cost_volume_kernel.py:71",
          "dtype": "float32", "shape": CV_SHAPES["slice"], "card": smi}
    b2_cuda_core = {
        "name": "cost_volume_cuda_core", **b2, "source": "fsvid2vid_tpu_torch/csrc/cost_volume.cu",
        "launches": train_res["cost_volume_launches_by_route"]["cuda_core"],
        "checked_on": "stride1", "max_abs_err": cv_res["stride1", "float32"]["max_abs_err"],
        "ms": cv_main["previous_design_ms"], "plain_ms": cv_main["plain_ms"],
        "bound_ms": cv_main["f32_cuda_core_bound_ms"], "bound_by": "operations",
        "library_ms": None}
    emit({"kernels": [{
        "name": "flash_ref_attention_sm90", **b1,
        "source": "fsvid2vid_tpu_torch/csrc/flash_ref_attention_sm90.cu",
        "launches": routes["sm90"], "max_abs_err": bf["max_abs_err_out"],
        **{k: bf[k] for k in keys}, "dtype": "bfloat16"}, {
        "name": "flash_ref_attention_sm90_f32", **b1,
        "source": "fsvid2vid_tpu_torch/csrc/flash_ref_attention_sm90.cu",
        "launches": routes["sm90_f32"], "max_abs_err": f32["max_abs_err_out"],
        **{k: f32[k] for k in keys}, "dtype": "float32",
        "f32_cuda_core_bound_ms": f32["f32_cuda_core_bound_ms"],
        "previous_design": b1_cuda_core}, {
        "name": "cost_volume_tc", **b2, "source": "fsvid2vid_tpu_torch/csrc/cost_volume_tc.cu",
        "launches": train_res["cost_volume_launches_by_route"]["tc"],
        "launches_by_path": {"train_face_256": train_res["cost_volume_launches_by_route"]["tc"],
                             "cli_train_face_256": cli_res["launches_train"]["tc"],
                             "cli_resume": cli_res["resume"]["launches"]["tc"]},
        **{k: cv_main[k] for k in cv_keys},
        **{k: cv_main[k] for k in ("previous_design_ms", "bound_share", "design_bound_ms",
                                   "design_bound_share", "f32_cuda_core_bound_ms")},
        "previous_design": b2_cuda_core,
        "other": {f"{case}_{d}": {k: r.get(k) for k in cv_keys + ("route", "previous_design_ms",
                                                                   "design_bound_ms")}
                  for (case, d), r in cv_res.items() if (case, d) != ("slice", "float32")}}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
