"""FlowNetC correlation cost volume: the CUDA kernel's wrapper, its plain
PyTorch version and the differentiable entry point, NCHW.

Port of fsvid2vid_tpu/ops/cost_volume.py::correlation and
fsvid2vid_tpu/ops/pallas/cost_volume_kernel.py::cost_volume_pallas.  With
d = max_displacement // stride, D = 2 d + 1 and dy, dx in
{-d * stride, ..., d * stride}:

  out[b, k, y, x] = (1/C) * sum_c f1[b, c, y, x] * f2[b, c, y + dy, x + dx]
  k = dy_idx * D + dx_idx, f2 read as zero outside the map

(kernel_size 1 and stride1 1, as FlowNetC uses the reference's correlation
layer).  f1, f2: (B, C, H, W) -> (B, D * D, H, W); the JAX functions are the
same with channels last.

The kernel (csrc/cost_volume.cu) is built with nvcc for sm_90a on first use
and loaded with ctypes (ops/cuda_build.py).  `cost_volume_cuda` launches the
kernel or raises; `correlation` runs the plain version only for CPU
tensors.  The backward is plain PyTorch on every device, as the JAX
package's VJP is a plain XLA shift-and-reduce: the flow teacher is frozen
and no training path differentiates through it.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fsvid2vid_tpu_torch.ops.cuda_build import CudaLibrary

SMEM_LIMIT = 232448    # dynamic shared memory one Hopper block may use


def _declare(lib):
    fn = lib.fsv_cost_volume
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.fsv_cost_volume_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.fsv_cost_volume_smem_bytes.restype = ctypes.c_size_t
    lib.fsv_cost_volume_max_d.argtypes = []
    lib.fsv_cost_volume_max_d.restype = ctypes.c_int


KERNEL = CudaLibrary("cost_volume", _declare)


def displacements(max_displacement: int, stride: int):
    """[(dy, dx)] in output-channel order (dy-major)."""
    d = max_displacement // stride
    return [(dy * stride, dx * stride)
            for dy in range(-d, d + 1) for dx in range(-d, d + 1)]


def _check_args(f1, f2, max_displacement, stride):
    if stride < 1 or max_displacement < 0:
        raise ValueError(f"cost volume: max_displacement={max_displacement}, "
                         f"stride={stride} not supported")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError("cost volume: expected f1 and f2 of one (B, C, H, W) "
                         f"shape, got {tuple(f1.shape)} and {tuple(f2.shape)}")
    if f1.dtype != f2.dtype or f1.device != f2.device:
        raise ValueError("cost volume: f1 and f2 differ in dtype or device")
    if f1.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cost volume: dtype {f1.dtype} not supported "
                         "(float32 or bfloat16)")


def cost_volume_plain(f1: torch.Tensor, f2: torch.Tensor,
                      max_displacement: int = 20, stride: int = 2) -> torch.Tensor:
    """Plain PyTorch version: one multiply-and-reduce over channels per
    displacement against a zero-padded f2, accumulated in f32; output in the
    input dtype."""
    _check_args(f1, f2, max_displacement, stride)
    b, c, h, w = f1.shape
    md = max_displacement
    f1_32 = f1.float()
    f2p = F.pad(f2.float(), (md, md, md, md))
    outs = [(f1_32 * f2p[:, :, md + dy:md + dy + h, md + dx:md + dx + w]).sum(1)
            for dy, dx in displacements(md, stride)]
    return (torch.stack(outs, 1) * (1.0 / c)).to(f1.dtype)


def cost_volume_cuda(f1: torch.Tensor, f2: torch.Tensor,
                     max_displacement: int = 20, stride: int = 2) -> torch.Tensor:
    """The kernel on CUDA tensors (forward only).  Raises on anything the
    kernel does not take and on a failed build or launch."""
    _check_args(f1, f2, max_displacement, stride)
    if f1.device.type != "cuda":
        raise ValueError(f"cost_volume_cuda: device {f1.device} is not CUDA")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("cost_volume_cuda: inputs must be contiguous")
    lib = KERNEL.load()
    b, c, h, w = f1.shape
    d = 2 * (max_displacement // stride) + 1
    if d > lib.fsv_cost_volume_max_d():
        raise ValueError(f"cost_volume_cuda: displacement grid {d} x {d} above "
                         f"the kernel's {lib.fsv_cost_volume_max_d()}")
    smem = lib.fsv_cost_volume_smem_bytes(max_displacement, stride)
    if smem > SMEM_LIMIT:
        raise ValueError(f"cost_volume_cuda: max_displacement={max_displacement} "
                         f"needs {smem} bytes of shared memory (limit {SMEM_LIMIT})")
    if h > 65535 or b > 65535:
        raise ValueError("cost_volume_cuda: B and H must be at most 65535")
    out = torch.empty(b, d * d, h, w, device=f1.device, dtype=f1.dtype)
    with torch.cuda.device(f1.device):
        err = lib.fsv_cost_volume(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, c, h, w,
            max_displacement, stride, int(f1.dtype == torch.bfloat16),
            torch.cuda.current_stream(f1.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cost_volume_cuda: kernel launch failed with CUDA "
                           f"error {err}")
    cost_volume_cuda.launches += 1
    return out


cost_volume_cuda.launches = 0


def cost_volume_backward_plain(f1, f2, grad, max_displacement: int, stride: int):
    """Transpose of the cost volume in plain PyTorch, f32 accumulation:

      df1[y, x, c] = (1/C) sum_k g[y, x, k]               * f2[y + dy_k, x + dx_k, c]
      df2[y, x, c] = (1/C) sum_k g[y - dy_k, x - dx_k, k] * f1[y - dy_k, x - dx_k, c]
    """
    b, c, h, w = f1.shape
    md = max_displacement
    pad = (md, md, md, md)
    g = grad.float()
    f2p = F.pad(f2.float(), pad)
    f1p = F.pad(f1.float(), pad)
    gp = F.pad(g, pad)
    df1 = torch.zeros(b, c, h, w, dtype=torch.float32, device=f1.device)
    df2 = torch.zeros_like(df1)
    for k, (dy, dx) in enumerate(displacements(md, stride)):
        df1 += g[:, k:k + 1] * f2p[:, :, md + dy:md + dy + h, md + dx:md + dx + w]
        df2 += (gp[:, k:k + 1, md - dy:md - dy + h, md - dx:md - dx + w]
                * f1p[:, :, md - dy:md - dy + h, md - dx:md - dx + w])
    return (df1 * (1.0 / c)).to(f1.dtype), (df2 * (1.0 / c)).to(f2.dtype)


class _Correlation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, max_displacement, stride):
        ctx.save_for_backward(f1, f2)
        ctx.args = (max_displacement, stride)
        if f1.device.type == "cpu":
            return cost_volume_plain(f1, f2, max_displacement, stride)
        return cost_volume_cuda(f1, f2, max_displacement, stride)

    @staticmethod
    def backward(ctx, grad):
        f1, f2 = ctx.saved_tensors
        df1, df2 = cost_volume_backward_plain(f1, f2, grad, *ctx.args)
        return df1, df2, None, None


def correlation(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20,
                stride: int = 2) -> torch.Tensor:
    """Differentiable cost volume: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors; backward in plain PyTorch on both."""
    return _Correlation.apply(f1, f2, max_displacement, stride)
