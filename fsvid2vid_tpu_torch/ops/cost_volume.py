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

One hand-written kernel computes it on the card, for every grid the TPU
kernel takes; `route_for` names the route from the device alone:

  CPU tensor                  -> the plain version
  CUDA, any md >= 0, s >= 1   -> "tc": csrc/cost_volume_tc.cu (banded
                                 tensor-core product over classes of pixels
                                 mod s and windows of horizontal shifts; any
                                 C and map size, B and H up to 65,535)

`tc_plan` mirrors the kernel's tiling (fsv_cost_volume_tc_plan).  The
kernel is built with nvcc for sm_90a on first use and loaded with ctypes
(ops/cuda_build.py).  `cost_volume_cuda` launches it or raises;
`correlation` runs the plain version only for CPU tensors.  The
dispatch is the torch operator fsv::cost_volume, registered when this
module is imported (its fake implementation gives the output shape and
launches nothing).  The backward is plain PyTorch on every device, as the
JAX package's VJP is a plain XLA shift-and-reduce: the flow teacher is
frozen and no training path differentiates through it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fsvid2vid_tpu_torch.ops.cuda_build import CudaLibrary

SMEM_LIMIT = 232448    # dynamic shared memory one Hopper block may use
# the tc kernel's tiling constants (csrc/cost_volume_tc.cu)
TC_CLASS_PX = 16       # pixels of one class: the m16 tile
TC_PIXELS = 32         # pixels of a block: two classes
TC_SLOTS = 4           # vertical shifts per step
TC_CS = 36             # staged channel stride (floats)
TC_MAX_NT = 5          # n8 tiles of f2 columns per class
TC_MAX_DW = 8 * TC_MAX_NT - 15   # horizontal shifts per window


def _declare_tc(lib):
    fn = lib.fsv_cost_volume_tc
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.fsv_cost_volume_tc_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.fsv_cost_volume_tc_scratch_bytes.restype = ctypes.c_size_t
    lib.fsv_cost_volume_tc_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.fsv_cost_volume_tc_smem_bytes.restype = ctypes.c_size_t
    lib.fsv_cost_volume_tc_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.fsv_cost_volume_tc_plan.restype = ctypes.c_int


KERNEL_TC = CudaLibrary("cost_volume_tc", _declare_tc)


def route_for(device_type: str, max_displacement: int, stride: int) -> str:
    """The rule: "plain" for inputs on the CPU, else "tc", whatever the
    displacement grid (the arguments are checked where the call is made)."""
    return "plain" if device_type == "cpu" else "tc"


class TcPlan(NamedTuple):
    """The tc kernel's tiling of one grid on rows of `width` pixels, field
    for field what fsv_cost_volume_tc_plan returns."""
    d: int             # shifts per axis
    radius: int        # R = stride * (max_displacement // stride)
    classes: int       # classes of pixels per block
    class_pixels: int  # pixels per class
    windows: int       # windows of horizontal shifts
    window_d: int      # shifts per window, at most TC_MAX_DW
    n_tiles: int       # n8 tiles of f2 columns per class and window
    x_blocks: int      # blocks along a row, windows included
    smem_bytes: int    # dynamic shared memory of one block


def tc_plan(max_displacement: int, stride: int, width: int = 1) -> TcPlan:
    """The tiling csrc/cost_volume_tc.cu picks: a row's pixels in classes of
    16 at step `stride`, two classes a block; the D horizontal shifts in
    ceil(D / 25) windows of equal width, each a 16 x 8 NT band product per
    class; two double-buffered staging buffers and the outputs of 4 shifts
    in shared memory."""
    if stride < 1 or max_displacement < 0 or width < 1:
        raise ValueError(f"cost volume: max_displacement={max_displacement}, "
                         f"stride={stride}, width={width} not supported")
    d = 2 * (max_displacement // stride) + 1
    windows = -(-d // TC_MAX_DW)
    window_d = -(-d // windows)
    n_tiles = (15 + window_d + 7) // 8
    spans = -(-width // (TC_CLASS_PX * stride))
    buffer_floats = (TC_PIXELS + TC_SLOTS * 16 * n_tiles) * TC_CS
    smem = 4 * (2 * buffer_floats + TC_SLOTS * window_d * TC_PIXELS)
    return TcPlan(d, max_displacement // stride * stride, 2, TC_CLASS_PX, windows,
                  window_d, n_tiles, (stride * spans + 1) // 2 * windows, smem)


def tc_class_first(cls: int, stride: int) -> int:
    """The first pixel of a row's class `cls` in the tc kernel (its pixels
    are that one + stride * i, i < 16): span cls // stride, residue
    cls % stride."""
    return TC_CLASS_PX * stride * (cls // stride) + cls % stride


def tc_plan_of_library(lib, max_displacement: int, stride: int, width: int = 1) -> TcPlan:
    """The same plan as the built kernel reports it."""
    plan = (ctypes.c_int * len(TcPlan._fields))()
    if lib.fsv_cost_volume_tc_plan(max_displacement, stride, width, plan) != 0:
        raise ValueError(f"fsv_cost_volume_tc_plan refused md={max_displacement}, "
                         f"stride={stride}, width={width}")
    return TcPlan(*plan)


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


def _check_cuda(f1, f2, max_displacement, stride):
    _check_args(f1, f2, max_displacement, stride)
    if f1.device.type != "cuda":
        raise ValueError(f"cost_volume_cuda: device {f1.device} is not CUDA")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("cost_volume_cuda: inputs must be contiguous")
    b, _, h, _ = f1.shape
    if h > 65535 or b > 65535:
        raise ValueError("cost_volume_cuda: B and H must be at most 65535")


def _raise_on(err, route):
    if err != 0:
        raise RuntimeError(f"cost_volume_cuda ({route}): kernel launch failed with "
                           f"CUDA error {err}")


def _count(route):
    cost_volume_cuda.launches += 1
    cost_volume_cuda.launches_by_route[route] += 1


def _launch_tc(f1, f2, max_displacement, stride):
    """The tensor-core kernel, for every grid.  Its pre-pass writes f1 and f2
    channels-last into a scratch tensor allocated here."""
    _check_cuda(f1, f2, max_displacement, stride)
    b, c, h, w = f1.shape
    lib = KERNEL_TC.load()
    d = 2 * (max_displacement // stride) + 1
    scratch = torch.empty(lib.fsv_cost_volume_tc_scratch_bytes(b, c, h, w),
                          dtype=torch.uint8, device=f1.device)
    out = torch.empty(b, d * d, h, w, device=f1.device, dtype=f1.dtype)
    with torch.cuda.device(f1.device):
        err = lib.fsv_cost_volume_tc(
            f1.data_ptr(), f2.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, c, h, w,
            max_displacement, stride, int(f1.dtype == torch.bfloat16),
            torch.cuda.current_stream(f1.device).cuda_stream)
    _raise_on(err, "tc")
    _count("tc")
    return out


def cost_volume_cuda(f1: torch.Tensor, f2: torch.Tensor,
                     max_displacement: int = 20, stride: int = 2) -> torch.Tensor:
    """The tensor-core kernel on CUDA tensors (forward only).  Raises on
    arguments the TPU kernel does not take either and on a failed build or
    launch."""
    return _launch_tc(f1, f2, max_displacement, stride)


# launches of the kernel, and by route
cost_volume_cuda.launches = 0
cost_volume_cuda.launches_by_route = {"tc": 0}


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


# B2 as a registered operator, so that a profiler's trace shows each launch
# with its shapes and device time, as it shows fsv::flash_ref_attention.
# The CUDA implementation looks `_launch_tc` up in this module at each call,
# so that a wrapper put in its place sees every launch.
@torch.library.custom_op("fsv::cost_volume", mutates_args=())
def cost_volume_op(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int,
                   stride: int) -> torch.Tensor:
    """CUDA: the tensor-core kernel, launched and counted, or an error."""
    return _launch_tc(f1, f2, max_displacement, stride)


@cost_volume_op.register_kernel("cpu")
def _(f1, f2, max_displacement, stride):
    return cost_volume_plain(f1, f2, max_displacement, stride)


@cost_volume_op.register_fake
def _(f1, f2, max_displacement, stride):
    _check_args(f1, f2, max_displacement, stride)
    b, _, h, w = f1.shape
    d = 2 * (max_displacement // stride) + 1
    return f1.new_empty(b, d * d, h, w)


def _save_inputs(ctx, inputs, output):
    f1, f2, max_displacement, stride = inputs
    ctx.save_for_backward(f1, f2)
    ctx.args = (max_displacement, stride)


def _backward(ctx, grad):
    f1, f2 = ctx.saved_tensors
    df1, df2 = cost_volume_backward_plain(f1, f2, grad, *ctx.args)
    return df1, df2, None, None


cost_volume_op.register_autograd(_backward, setup_context=_save_inputs)


def correlation(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20,
                stride: int = 2) -> torch.Tensor:
    """Differentiable cost volume through the registered operator
    fsv::cost_volume: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors; backward in plain PyTorch on both."""
    return cost_volume_op(f1, f2, max_displacement, stride)
