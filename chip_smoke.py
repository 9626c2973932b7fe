#!/usr/bin/env python3
"""Smoke test of the PyTorch port (fsvid2vid_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version on the card, then drives the port's
serving path end to end: K-shot face synthesis at 512 px with K = 8
references and the full width of face_config (the path that runs the kernel
once per frame), and the K = 1 face-256 forward.  Each phase prints one
JSON line; the kernels line comes before the last line, and the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

The slice phase's line also holds a torch.profiler breakdown of one warm
K = 8 frame per dtype.  Any failure raises and exits non-zero.  Without a CUDA device, or without
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
H100_F32_FLOPS = 67e12     # outside the tensor cores
H100_BYTES_PER_S = 3.35e12

# the attention at face 512 px, K = 8, n_downsample_A = 2 (B=1, hw=128^2)
SLICE = dict(b=1, hw=128 * 128, n_refs=8, c=128, has_lf=True)
RAGGED = dict(b=2, hw=13 * 11, n_refs=3, c=40, has_lf=False)
# kernel vs plain version, max abs error on outputs / on the masses:
#  ragged, f32: the same f32 math in another order: 1e-4 / 1e-5 (the CPU
#    tests' tolerances);
#  slice, f32: every f32 accumulator sums N = 131072 keys in sequence, so
#    rounding grows to ~sqrt(N) * 6e-8 ~ 2e-5 relative on outputs of up to
#    ~5: 5e-4 / 1e-4 (one PyTorch attention call differs from the plain
#    version by the same order);
#  bf16: the kernel rounds p to bf16 before the value products (as the TPU
#    kernel does) and both round the outputs to bf16: 3e-2 / 1e-4.
TOL = {("ragged", "float32"): (1e-4, 1e-5), ("slice", "float32"): (5e-4, 1e-4),
       ("ragged", "bfloat16"): (3e-2, 1e-4), ("slice", "bfloat16"): (3e-2, 1e-4)}
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
    from fsvid2vid_tpu_torch.ops import attention_kernel as ak
    seconds, log = ak.build(verbose=True)
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "kernel": "flash_ref_attention",
          "source": str(ak.SOURCE.relative_to(REPO)), "seconds": seconds,
          "ptxas": ptxas})


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


def attention_inputs(torch, b, hw, n_refs, c, has_lf, dtype, seed=0):
    """Seeded inputs whose energies have a standard deviation of ~4, so the
    softmax is neither one-hot nor flat."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = n_refs * hw
    scale = 2.0 / c ** 0.25

    def mk(rows, s=1.0):
        return (torch.randn(b, rows, c, device="cuda", generator=g) * s).to(dtype)
    return mk(hw, scale), mk(n, scale), mk(n), mk(n) if has_lf else None


def attention_cost(b, hw, n_refs, c, has_lf, dtype_bytes):
    """FLOP and bytes of one call: QK^T plus one PV product per value
    tensor; each input read once, each output written once."""
    n = n_refs * hw
    n_values = 2 if has_lf else 1
    flops = 2.0 * b * hw * n * c * (1 + n_values)
    nbytes = (dtype_bytes * (b * hw * c * (1 + n_values) + b * n * c * (1 + n_values))
              + 4 * b * hw * n_refs)
    return flops, nbytes


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


def check_kernel(torch, dtype_name, case, shape, timed):
    from fsvid2vid_tpu_torch.ops.attention_kernel import (
        flash_ref_attention, flash_ref_attention_plain)
    dtype = getattr(torch, dtype_name)
    n_refs = shape["n_refs"]
    q, k, xf, lf = attention_inputs(torch, dtype=dtype, **shape)
    ox, ol, vis = flash_ref_attention(q, k, xf, lf, n_refs)
    torch.cuda.synchronize()
    px, pl_, pvis = flash_ref_attention_plain(q, k, xf, lf, n_refs)
    torch.cuda.synchronize()
    for name, t in (("out_x", ox), ("out_l", ol), ("vis", vis)):
        if t is not None and not torch.isfinite(t).all():
            raise AssertionError(f"kernel {name} not finite ({dtype_name})")
    err_out = (ox.float() - px.float()).abs().max().item()
    if lf is not None:
        err_out = max(err_out, (ol.float() - pl_.float()).abs().max().item())
    err_vis = (vis - pvis).abs().max().item()
    tol_out, tol_vis = TOL[case, dtype_name]
    ok = err_out <= tol_out and err_vis <= tol_vis
    res = {"phase": "kernel_check", "kernel": "flash_ref_attention",
           "case": case, "dtype": dtype_name, "shape": shape,
           "max_abs_err_out": err_out, "tol_out": tol_out,
           "max_abs_err_vis": err_vis, "tol_vis": tol_vis, "ok": ok}
    if timed and ok:
        res["ms"] = cuda_ms(torch, lambda: flash_ref_attention(q, k, xf, lf, n_refs), 5)
        res["plain_ms"] = cuda_ms(
            torch, lambda: flash_ref_attention_plain(q, k, xf, lf, n_refs), 2)
        lib = library_attention(torch, q, k, xf, lf, n_refs)
        out = lib()
        res["library_max_abs_err_vis"] = (out[:, 0, :, -n_refs:].float()
                                          - pvis).abs().max().item()
        del out
        res["library_ms"] = cuda_ms(torch, lib, 5)
        flops, nbytes = attention_cost(shape["b"], shape["hw"], n_refs,
                                       shape["c"], shape["has_lf"], q.element_size())
        peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
        res.update(flop=flops, bytes=nbytes,
                   bound_ms=1e3 * max(flops / peak, nbytes / H100_BYTES_PER_S),
                   bound_by=("operations" if flops / peak >= nbytes / H100_BYTES_PER_S
                             else "bytes"))
    emit(res)
    if not ok:
        raise AssertionError(f"flash_ref_attention {case} {dtype_name}: error "
                             f"{err_out}/{err_vis} above {tol_out}/{tol_vis}")
    return res


def phase_kernels(torch):
    slice_res = {d: check_kernel(torch, d, "slice", SLICE, True)
                 for d in ("bfloat16", "float32")}
    for d in ("bfloat16", "float32"):
        check_kernel(torch, d, "ragged", RAGGED, False)
    torch.cuda.empty_cache()
    return slice_res


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


def profile_step(torch, pipe, label):
    """Device time of one warm pipeline step by kernel (torch.profiler's
    CUDA kernel records; CUPTI's own buffer records left out): the 10
    largest, their sum, and the step's host-clock ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cupti_records = {"Activity Buffer Request", "Buffer Flush", "Command Buffer Full"}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.step(label)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in cupti_records:
            ms, n = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    device_ms = sum(ms for ms, _ in by_kernel.values())
    return {"step_ms": step_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / step_ms, "kernel_launches":
            sum(n for _, n in by_kernel.values()),
            "top": [{"kernel": k[:90], "ms": ms, "calls": n} for k, (ms, n) in rows[:10]]}


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
    ak.flash_ref_attention.launches = 0
    out = {}
    for dtype in ("bfloat16", "float32"):
        pipe = InferencePipeline(cfg, g, compute_dtype=dtype)
        out[dtype] = run_frames(torch, pipe, labels, ref_labels, ref_images)
    launches = ak.flash_ref_attention.launches
    res["launches"] = launches
    for dtype, (frames, ms, reset_ms, ref_idx) in out.items():
        res[dtype] = {"frame_ms": ms, "reset_ms": reset_ms, "ref_idx": ref_idx,
                      "frame_std": frames.std().item()}
    if launches != 4 * N_FRAMES:
        raise AssertionError(f"kernel launches {launches} != frames {4 * N_FRAMES}")
    for dtype in ("bfloat16", "float32"):   # one warm frame with warp_prev
        pipe = InferencePipeline(cfg, g, compute_dtype=dtype)
        pipe.reset(ref_labels, ref_images, labels[0])
        pipe.step(labels[0])
        res[f"profile_{dtype}"] = profile_step(torch, pipe, labels[1])

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
    slice_res = phase_slice(torch)
    phase_small(torch)
    phase_k1(torch)
    bf, f32 = kern["bfloat16"], kern["float32"]
    emit({"kernels": [{
        "name": "flash_ref_attention", "route": "cuda",
        "source": "fsvid2vid_tpu_torch/csrc/flash_ref_attention.cu",
        "replaces": "fsvid2vid_tpu/ops/pallas/attention_kernel.py:158",
        "launches": slice_res["launches"],
        "max_abs_err": bf["max_abs_err_out"], "ms": bf["ms"],
        "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
        "bound_by": bf["bound_by"], "library_ms": bf["library_ms"],
        "dtype": "bfloat16", "shape": SLICE, "card": smi,
        "f32": {k: f32[k] for k in ("max_abs_err_out", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
