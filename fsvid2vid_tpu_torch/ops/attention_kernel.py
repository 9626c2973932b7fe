"""Multi-reference flash attention: the CUDA kernels' wrapper and its plain
PyTorch version, `chunked_ref_attention`, which is also the generator's
differentiable train-mode attention.

Port of fsvid2vid_tpu/ops/pallas/attention_kernel.py::flash_ref_attention.
With N = n_refs * hw_key keys:

  out_x[b,q,:] = sum_n softmax_n(key[b,n,:] . query[b,q,:]) * xf[b,n,:]
  out_l[b,q,:] = the same weights applied to lf (optional)
  vis[b,q,r]   = the softmax mass on the keys of reference r

Three hand-written kernels compute it on the card; `route_for` picks one
from where the inputs lie, their dtype and their channel count, before any
launch:

  CPU tensor                          -> the plain version
  CUDA, bf16, c % 8 == 0, c <= 128    -> "sm90": csrc/flash_ref_attention_sm90.cu
                                         (wgmma, TMA, warp specialisation)
  CUDA, f32, c % 8 == 0, c <= 128     -> "sm90_f32": the same source's f32
                                         instance (split-bf16 products)
  CUDA, c % 8 != 0                    -> "cuda_core": csrc/flash_ref_attention.cu

Each is built with nvcc for sm_90a on first use into fsvid2vid_tpu_torch/build/
and loaded with ctypes (ops/cuda_build.py).  A CUDA call launches the routed
kernel or raises: nothing falls back to the other kernel or to the plain
version.  The dispatch is the torch operator fsv::flash_ref_attention,
registered when this module is imported (its fake implementation gives the
output shapes and launches nothing), so that torch.export traces through it
and a saved program calls it by name (inference/serve.py).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from fsvid2vid_tpu_torch.ops.cuda_build import CudaLibrary

MAX_C = 128            # channels the kernels take (csrc MAX_C)
SMEM_LIMIT = 232448    # dynamic shared memory one Hopper block may use

# the bf16 sm90 kernel's shared memory (csrc/flash_ref_attention_sm90.cu
# smem_bytes<bf16>): 1024 bytes of alignment slack, a 128-query tile and 3 stages
# of 64-key tiles [K | xf | lf] in 64-channel boxes, 7 mbarriers, and a
# (128, n_refs) table of float2
_SM90_STAGES = 3


def sm90_smem_bytes(c: int, n_refs: int, has_lf: bool) -> int:
    boxes = 1 if c <= 64 else 2
    stage = boxes * 64 * 128 * (3 if has_lf else 2)
    return (1024 + boxes * 128 * 128 + _SM90_STAGES * stage + 8 * (2 * _SM90_STAGES + 1)
            + 128 * n_refs * 8)


# the f32 one's (smem_bytes<float>): the 128-query tile in 3 bf16 parts, 2
# stages of 32-key tiles [K in 3 parts | xf and lf in 2 parts], 5 mbarriers
# and the same table
_SM90_F32_STAGES = 2


def sm90_f32_smem_bytes(c: int, n_refs: int, has_lf: bool) -> int:
    boxes = 1 if c <= 64 else 2
    stage = (3 * boxes + 2 * boxes * (2 if has_lf else 1)) * 32 * 128
    return (1024 + 3 * boxes * 128 * 128 + _SM90_F32_STAGES * stage
            + 8 * (2 * _SM90_F32_STAGES + 1) + 128 * n_refs * 8)


def _declare(lib):
    fn = lib.fsv_flash_ref_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    smem = lib.fsv_flash_ref_attention_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_size_t


def _declare_sm90(lib):
    fn = lib.fsv_flash_ref_attention_sm90
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fsv_flash_ref_attention_sm90_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scratch = lib.fsv_flash_ref_attention_sm90_f32_scratch_bytes
    scratch.argtypes = [ctypes.c_int] * 6
    scratch.restype = ctypes.c_size_t


KERNEL = CudaLibrary("flash_ref_attention", _declare)
KERNEL_SM90 = CudaLibrary("flash_ref_attention_sm90", _declare_sm90)   # both sm90 routes


def route_for(device_type: str, dtype: torch.dtype, c: int) -> str:
    """The rule: "plain", "sm90", "sm90_f32" or "cuda_core" for inputs on
    `device_type` of `dtype` with `c` channels.  f32 reaches the tensor cores
    only as split-bf16 products (TF32 alone would not hold the f32 checks)."""
    if device_type == "cpu":
        return "plain"
    if c % 8 == 0 and c <= MAX_C:
        return "sm90" if dtype == torch.bfloat16 else "sm90_f32"
    return "cuda_core"


def chunked_ref_attention(query, key, xf, lf, n_refs: int, chunk_elems: int = 1 << 23):
    """The K > 1 attention in plain, differentiable PyTorch: the non-flash
    branch of the JAX `_attention_module`
    (fsvid2vid_tpu/models/generator.py:306-340), which the generator runs in
    train mode and finetune (B1 has no backward), and B1's plain version.
    A softmax over the N = n_refs·hw keys, one query chunk at a time: the
    chunk is the largest power of two (halving from hw) whose energy holds
    at most `chunk_elems` elements per sample (N x chunk), so the whole
    (B, N, hw) energy is never held at once; a last chunk that the halving
    leaves shorter gives the same result (where JAX asserts instead).  The
    energy is held as (B, chunk, N), the transpose of JAX's, so that the
    softmax runs over its contiguous last axis: over the middle axis
    PyTorch's CUDA softmax took 11 ms per chunk at face 512 / K = 8 on an
    H100, 2.9 s a call.

    Arguments and results as flash_ref_attention's: query (B, hw, c), key /
    xf / lf (B, N, c), lf optional -> out_x, out_l (B, hw, c) in the dtype
    of xf / lf, vis (B, hw, n_refs) f32, each reference's share of each
    query's softmax mass.  Everything inside runs in f32 with autocast off,
    as the JAX branch upcasts its inputs."""
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


# B1's plain version is the same function
flash_ref_attention_plain = chunked_ref_attention


def _check(query, key, xf, lf, n_refs):
    tensors = [query, key, xf] + ([lf] if lf is not None else [])
    if any(t.device != query.device for t in tensors):
        raise ValueError("flash_ref_attention: inputs on different devices")
    if query.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_ref_attention: dtype {query.dtype} not "
                         "supported (float32 or bfloat16)")
    if any(t.dtype != query.dtype for t in tensors):
        raise ValueError("flash_ref_attention: inputs of different dtypes")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("flash_ref_attention: inputs must be contiguous")
    if query.dim() != 3 or any(t.dim() != 3 for t in tensors):
        raise ValueError("flash_ref_attention: expected (B, hw, c) query and "
                         "(B, N, c) key/values")
    b, hw, c = query.shape
    n = key.shape[1]
    if any(t.shape != (b, n, c) for t in tensors[1:]):
        raise ValueError("flash_ref_attention: key/xf/lf must all be "
                         f"(B, N, c) = {(b, n, c)}")
    if n_refs < 1 or n % n_refs or n < n_refs:
        raise ValueError(f"flash_ref_attention: N={n} is not a multiple of "
                         f"n_refs={n_refs}")
    if not 1 <= c <= MAX_C:
        raise ValueError(f"flash_ref_attention: c={c} outside 1..{MAX_C} "
                         "(the kernel stages c channels in shared memory)")


def _check_tensor_core(route, dtype, smem_bytes, query, key, xf, lf, n_refs):
    """What a tensor-core kernel needs beyond _check: its dtype, c % 8 == 0
    (TMA rows are 16-byte strided), 16-byte aligned tensors, and its shared
    memory."""
    _check(query, key, xf, lf, n_refs)
    c = query.shape[2]
    if query.dtype != dtype or c % 8:
        raise ValueError(f"flash_ref_attention {route}: needs {dtype} and c % 8 == 0, "
                         f"got {query.dtype} and c={c}")
    tensors = [query, key, xf] + ([lf] if lf is not None else [])
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"flash_ref_attention {route}: tensors must be 16-byte aligned")
    smem = smem_bytes(c, n_refs, lf is not None)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_ref_attention {route}: n_refs={n_refs} needs {smem} "
                         f"bytes of shared memory (limit {SMEM_LIMIT})")


def _check_sm90(query, key, xf, lf, n_refs):
    _check_tensor_core("sm90", torch.bfloat16, sm90_smem_bytes, query, key, xf, lf, n_refs)


def _check_sm90_f32(query, key, xf, lf, n_refs):
    _check_tensor_core("sm90_f32", torch.float32, sm90_f32_smem_bytes, query, key, xf, lf,
                       n_refs)


def _outputs(query, lf, n_refs):
    b, hw, _ = query.shape
    out_x = torch.empty_like(query)
    out_l = torch.empty_like(query) if lf is not None else None
    vis = torch.empty(b, hw, n_refs, device=query.device, dtype=torch.float32)
    return out_x, out_l, vis


def _count(route):
    flash_ref_attention.launches += 1
    flash_ref_attention.launches_by_route[route] += 1


def _raise_on(err, route):
    if err == 0:
        return
    what = {-1: "the CUDA driver has no cuTensorMapEncodeTiled",
            -2: "a TMA tensor map could not be encoded"}.get(err, f"CUDA error {err}")
    raise RuntimeError(f"flash_ref_attention ({route}): kernel launch failed: {what}")


def _launch_sm90(query, key, xf, lf, n_refs):
    _check_sm90(query, key, xf, lf, n_refs)
    lib = KERNEL_SM90.load()
    b, hw, c = query.shape
    out_x, out_l, vis = _outputs(query, lf, n_refs)
    with torch.cuda.device(query.device):
        err = lib.fsv_flash_ref_attention_sm90(
            query.data_ptr(), key.data_ptr(), xf.data_ptr(),
            lf.data_ptr() if lf is not None else None,
            out_x.data_ptr(), out_l.data_ptr() if out_l is not None else None,
            vis.data_ptr(), b, hw, key.shape[1], c, n_refs,
            torch.cuda.current_stream(query.device).cuda_stream)
    _raise_on(err, "sm90")
    _count("sm90")
    return out_x, out_l, vis


def _launch_sm90_f32(query, key, xf, lf, n_refs):
    """The f32 tensor-core kernel; its split pre-pass writes the bf16 parts
    of the inputs into a scratch tensor allocated here."""
    _check_sm90_f32(query, key, xf, lf, n_refs)
    lib = KERNEL_SM90.load()
    b, hw, c = query.shape
    n = key.shape[1]
    has_lf = lf is not None
    scratch = torch.empty(
        lib.fsv_flash_ref_attention_sm90_f32_scratch_bytes(b, hw, n, c, n_refs, int(has_lf)),
        dtype=torch.uint8, device=query.device)
    out_x, out_l, vis = _outputs(query, lf, n_refs)
    with torch.cuda.device(query.device):
        err = lib.fsv_flash_ref_attention_sm90_f32(
            query.data_ptr(), key.data_ptr(), xf.data_ptr(),
            lf.data_ptr() if has_lf else None, scratch.data_ptr(),
            out_x.data_ptr(), out_l.data_ptr() if has_lf else None,
            vis.data_ptr(), b, hw, n, c, n_refs,
            torch.cuda.current_stream(query.device).cuda_stream)
    _raise_on(err, "sm90_f32")
    _count("sm90_f32")
    return out_x, out_l, vis


def _launch_cuda_core(query, key, xf, lf, n_refs):
    """The CUDA-core kernel: f32 and bf16 with c % 8 != 0."""
    _check(query, key, xf, lf, n_refs)
    lib = KERNEL.load()
    b, hw, c = query.shape
    smem = lib.fsv_flash_ref_attention_smem_bytes(c, n_refs, lf is not None)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_ref_attention: n_refs={n_refs} needs {smem} "
                         f"bytes of shared memory (limit {SMEM_LIMIT})")
    out_x, out_l, vis = _outputs(query, lf, n_refs)
    with torch.cuda.device(query.device):
        err = lib.fsv_flash_ref_attention(
            query.data_ptr(), key.data_ptr(), xf.data_ptr(),
            lf.data_ptr() if lf is not None else None,
            out_x.data_ptr(), out_l.data_ptr() if out_l is not None else None,
            vis.data_ptr(), b, hw, key.shape[1], c, n_refs,
            int(query.dtype == torch.bfloat16),
            torch.cuda.current_stream(query.device).cuda_stream)
    _raise_on(err, "cuda_core")
    _count("cuda_core")
    return out_x, out_l, vis


_LAUNCH = {"sm90": _launch_sm90, "sm90_f32": _launch_sm90_f32,
           "cuda_core": _launch_cuda_core}


# B1 as a registered operator, so that torch.export and FakeTensor can trace
# through it and a saved program that calls it reloads by name in another
# process.  A custom op cannot return None, so `out_l` comes back as an
# empty tensor when `lf` is None; `flash_ref_attention` maps it back.
@torch.library.custom_op("fsv::flash_ref_attention", mutates_args=())
def flash_ref_attention_op(query: torch.Tensor, key: torch.Tensor, xf: torch.Tensor,
                           lf: Optional[torch.Tensor], n_refs: int
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CUDA: the routed kernel, launched and counted, or an error; nothing
    falls back to another kernel or to the plain version."""
    route = route_for(query.device.type, query.dtype, query.shape[-1])
    out_x, out_l, vis = _LAUNCH[route](query, key, xf, lf, n_refs)
    return out_x, _empty_if_none(out_l, query), vis


@flash_ref_attention_op.register_kernel("cpu")
def _(query, key, xf, lf, n_refs):
    out_x, out_l, vis = flash_ref_attention_plain(query, key, xf, lf, n_refs)
    return out_x, _empty_if_none(out_l, query), vis


@flash_ref_attention_op.register_fake
def _(query, key, xf, lf, n_refs):
    b, hw, c = query.shape
    out_l = query.new_empty(b, hw, c) if lf is not None else query.new_empty(0)
    return query.new_empty(b, hw, c), out_l, query.new_empty(b, hw, n_refs,
                                                             dtype=torch.float32)


def _empty_if_none(out_l, query):
    return query.new_empty(0) if out_l is None else out_l


def flash_ref_attention(query, key, xf, lf, n_refs: int):
    """Streaming-softmax multi-reference attention (forward only).

    query: (B, hw, c); key, xf and optional lf: (B, N, c), N = n_refs * hw_key;
    float32 or bfloat16.  Returns (out_x (B, hw, c), out_l (B, hw, c) or None,
    vis (B, hw, n_refs) float32).  Accumulation is f32; for bf16 inputs the
    softmax weights are rounded to bf16 before the value products.  Runs the
    registered operator fsv::flash_ref_attention: the plain version for CPU
    tensors, the routed kernel for CUDA ones."""
    if query.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_ref_attention: device {query.device} not "
                         "supported")
    out_x, out_l, vis = flash_ref_attention_op(query, key, xf, lf, n_refs)
    return out_x, (out_l if lf is not None else None), vis


# launches of any kernel, and by route
flash_ref_attention.launches = 0
flash_ref_attention.launches_by_route = {route: 0 for route in _LAUNCH}
