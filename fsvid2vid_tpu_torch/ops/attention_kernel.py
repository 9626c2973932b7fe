"""Multi-reference flash attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of fsvid2vid_tpu/ops/pallas/attention_kernel.py::flash_ref_attention.
With N = n_refs * hw_key keys:

  out_x[b,q,:] = sum_n softmax_n(key[b,n,:] . query[b,q,:]) * xf[b,n,:]
  out_l[b,q,:] = the same weights applied to lf (optional)
  vis[b,q,r]   = the softmax mass on the keys of reference r

The kernel (csrc/flash_ref_attention.cu) is built with nvcc for sm_90a on
first use into fsvid2vid_tpu_torch/build/ and loaded with ctypes
(ops/cuda_build.py).  The wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from fsvid2vid_tpu_torch.ops.cuda_build import CudaLibrary

MAX_C = 128            # channels the kernel takes (csrc MAX_C)
SMEM_LIMIT = 232448    # dynamic shared memory one Hopper block may use


def _declare(lib):
    fn = lib.fsv_flash_ref_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    smem = lib.fsv_flash_ref_attention_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_size_t


KERNEL = CudaLibrary("flash_ref_attention", _declare)


def flash_ref_attention_plain(query, key, xf, lf, n_refs: int,
                              chunk_elems: int = 1 << 23):
    """Plain PyTorch version: the generator's chunked streaming softmax
    (fsvid2vid_tpu/models/generator.py:306-340) in f32, chunked over queries
    so the (B, N, q_chunk) energy slab stays under `chunk_elems` per batch.

    Returns (out_x, out_l or None, vis) like flash_ref_attention."""
    b, hw, c = query.shape
    n = key.shape[1]
    q_chunk = hw
    while q_chunk > 1 and n * q_chunk > chunk_elems:
        q_chunk //= 2
    q32, k32, x32 = query.float(), key.float(), xf.float()
    l32 = lf.float() if lf is not None else None
    outs_x, outs_l, viss = [], [], []
    for s in range(0, hw, q_chunk):
        energy = torch.bmm(k32, q32[:, s:s + q_chunk].transpose(1, 2))
        attn = torch.softmax(energy, dim=1)                 # (b, n, qc)
        attn_t = attn.transpose(1, 2)
        outs_x.append(torch.bmm(attn_t, x32))
        if l32 is not None:
            outs_l.append(torch.bmm(attn_t, l32))
        viss.append(attn.reshape(b, n_refs, n // n_refs, -1).sum(2)
                    .transpose(1, 2))
    out_x = torch.cat(outs_x, 1).to(xf.dtype)
    out_l = torch.cat(outs_l, 1).to(xf.dtype) if l32 is not None else None
    return out_x, out_l, torch.cat(viss, 1)


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


def flash_ref_attention(query, key, xf, lf, n_refs: int):
    """Streaming-softmax multi-reference attention (forward only).

    query: (B, hw, c); key, xf and optional lf: (B, N, c), N = n_refs * hw_key;
    float32 or bfloat16.  Returns (out_x (B, hw, c), out_l (B, hw, c) or None,
    vis (B, hw, n_refs) float32).  Accumulation is f32; for bf16 inputs the
    softmax weights are rounded to bf16 before the value products."""
    if query.device.type == "cpu":
        return flash_ref_attention_plain(query, key, xf, lf, n_refs)
    if query.device.type != "cuda":
        raise ValueError(f"flash_ref_attention: device {query.device} not "
                         "supported")
    _check(query, key, xf, lf, n_refs)
    lib = KERNEL.load()
    b, hw, c = query.shape
    n = key.shape[1]
    smem = lib.fsv_flash_ref_attention_smem_bytes(c, n_refs, lf is not None)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_ref_attention: n_refs={n_refs} needs {smem} "
                         f"bytes of shared memory (limit {SMEM_LIMIT})")
    out_x = torch.empty_like(query)
    out_l = torch.empty_like(query) if lf is not None else None
    vis = torch.empty(b, hw, n_refs, device=query.device, dtype=torch.float32)
    with torch.cuda.device(query.device):
        err = lib.fsv_flash_ref_attention(
            query.data_ptr(), key.data_ptr(), xf.data_ptr(),
            lf.data_ptr() if lf is not None else None,
            out_x.data_ptr(), out_l.data_ptr() if out_l is not None else None,
            vis.data_ptr(), b, hw, n, c, n_refs,
            int(query.dtype == torch.bfloat16),
            torch.cuda.current_stream(query.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_ref_attention: kernel launch failed with "
                           f"CUDA error {err}")
    flash_ref_attention.launches += 1
    return out_x, out_l, vis


flash_ref_attention.launches = 0
