"""The served forward's eval-mode norm as one pass: the CUDA kernel's
wrapper, its plain PyTorch version and the route between them.

At eval a batch norm is a fixed per-channel affine map, and SPADE's
modulations and the leaky ReLU that follows are elementwise.  With c
channels, `scale` and `shift` (c,) in f32 and up to three maps, each
(B, 2c, H, W) with gamma in its first c channels and beta in the next c:

  y = x * scale + shift
  y = y * (1 + gamma_m) + beta_m       for each map m
  y = leaky_relu(y, slope)             where a slope is given

`norm_modulate_plain` is the composition models/layers.py ran on every
call before the kernel (and runs on every call the route leaves to it):
addcmul in f32, the result in x's dtype, each map in the promoted dtype,
then leaky_relu.  csrc/norm_modulate.cu computes the same in f32 registers
and rounds once, to the output dtype.  The route follows what the call
shows (`fused_route`):

  fused  an eval-mode norm on a channels-last input of c % 8 == 0
         channels, in a call that autograd does not record (the served
         forward): the registered operator fsv::norm_modulate, the kernel
         on a CUDA tensor, the plain version on a CPU one;
  plain  every other call (training and finetune: train mode, batch
         statistics, gradients; NCHW inputs): the plain version, as the
         norm ran before.

The fused output's dtype is autocast's where autocast is on for x's
device, else x's (`served_dtype`): every fused norm feeds a convolution
(directly or through its leaky ReLU), which reads that dtype, so the
consumer is handed what autocast would hand it.  The maps are in that
dtype too, as every served call has them: the convolutions' outputs under
autocast, else the working dtype throughout.  The kernel is built with
nvcc for sm_90a on first use and loaded with ctypes (ops/cuda_build.py).
A CUDA call launches it or raises.  `norm_modulate.calls_by_route` counts
the calls of each route, `norm_modulate.launches` the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from fsvid2vid_tpu_torch.ops.cuda_build import CudaLibrary
from fsvid2vid_tpu_torch.ops.image_ops import channels_innermost, leaky_relu, records_grad

MAX_MAPS = 3


def _declare(lib):
    ptr = ctypes.c_void_p
    fn = lib.fsv_norm_modulate
    fn.argtypes = ([ptr] * 6 + [ctypes.c_int, ptr, ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_float] + [ctypes.c_int] * 2 + [ptr])
    fn.restype = ctypes.c_int


KERNEL = CudaLibrary("norm_modulate", _declare)


def served_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a convolution of x reads: autocast's where it is on for
    x's device, else x's."""
    dev = x.device.type
    return torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype


def fused_route(x: torch.Tensor, maps: Sequence[torch.Tensor], *params) -> bool:
    """An eval-mode norm of `x` (the caller checks the mode) with `maps`
    takes the fused route: x channels-last with c % 8 == 0, at most
    MAX_MAPS maps, each in the output's dtype, and autograd records nothing
    on x, the maps or `params` (the affine parameters)."""
    return (channels_innermost(x) and x.shape[1] % 8 == 0 and len(maps) <= MAX_MAPS
            and all(m.dtype == served_dtype(x) for m in maps)
            and not records_grad(x, *maps, *params))


def affine_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """x * scale + shift per channel, in f32, cast back to x's dtype."""
    return torch.addcmul(shift[:, None, None], x.float(), scale[:, None, None]).to(x.dtype)


def modulate_plain(y: torch.Tensor, maps: Sequence[torch.Tensor],
                   slope: Optional[float]) -> torch.Tensor:
    """SPADE's modulations of a normalised y, then the leaky ReLU."""
    c = y.shape[1]
    for gb in maps:
        y = y * (1 + gb[:, :c]) + gb[:, c:]
    return y if slope is None else leaky_relu(y, slope)


def norm_modulate_plain(x, scale, shift, maps: Sequence[torch.Tensor] = (),
                        slope: Optional[float] = None) -> torch.Tensor:
    """The plain version: `affine_plain`, then `modulate_plain`."""
    return modulate_plain(affine_plain(x, scale, shift), maps, slope)


def _check(x, scale, shift, maps, out_dtype):
    """What every implementation takes.  Not the layout: a saved program
    calls the operator where its trace saw a channels-last input, and the
    input it is given may be laid out otherwise (`_dense` copies it)."""
    c = x.shape[1]
    if x.dim() != 4 or c % 8:
        raise ValueError(f"norm_modulate: x must be a (B, C, H, W) map with C % 8 == 0, "
                         f"got shape {tuple(x.shape)}")
    if scale.shape != (c,) or shift.shape != (c,):
        raise ValueError(f"norm_modulate: scale and shift must be ({c},)")
    if len(maps) > MAX_MAPS:
        raise ValueError(f"norm_modulate: at most {MAX_MAPS} maps, got {len(maps)}")
    want = (x.shape[0], 2 * c, x.shape[2], x.shape[3])
    for m in maps:
        if tuple(m.shape) != want:
            raise ValueError(f"norm_modulate: a map must be {want}, got {tuple(m.shape)}")
    if any(m.dtype != out_dtype for m in maps):
        raise ValueError(f"norm_modulate: the maps must be in the output's dtype {out_dtype}")
    for dtype in (x.dtype, out_dtype):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"norm_modulate: dtype {dtype} (float32 or bfloat16)")


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel reads it: channels-last, dense, 16-byte aligned."""
    t = t.contiguous(memory_format=torch.channels_last)
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.channels_last)


def _launch(x, scale, shift, maps, slope, out_dtype):
    """The kernel on CUDA tensors, on the current stream."""
    _check(x, scale, shift, maps, out_dtype)
    if x.device.type != "cuda" or any(t.device != x.device for t in (scale, shift, *maps)):
        raise ValueError("norm_modulate: the kernel takes CUDA tensors on one device")
    lib = KERNEL.load()
    x = _dense(x)
    maps = [_dense(m) for m in maps]
    scale, shift = (t.float().contiguous() for t in (scale, shift))
    out = torch.empty_like(x, dtype=out_dtype, memory_format=torch.channels_last)
    b, c, h, w = x.shape
    ptrs = [m.data_ptr() for m in maps] + [None] * (MAX_MAPS - len(maps))
    with torch.cuda.device(x.device):
        err = lib.fsv_norm_modulate(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), *ptrs, len(maps),
            out.data_ptr(), b * h * w, c, 1.0 if slope is None else float(slope),
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"norm_modulate: kernel launch failed with CUDA error {err}")
    norm_modulate.launches += 1
    return out


# The fused route as a registered operator, so that torch.export traces
# through it and a saved program calls it by name (inference/serve.py), and
# a profiler's trace shows each call with its shapes.  The maps are three
# optional inputs, not a list, so that the trace records each one's shape.
# It is defined through torch.library.Library and not custom_op, whose
# wrapper imports torch._dynamo at the first call: seconds of a serving
# process's set-up where no other operator imports it (the street cell).
_LIB = torch.library.Library("fsv", "FRAGMENT")
_LIB.define("norm_modulate(Tensor x, Tensor scale, Tensor shift, Tensor? map0, "
            "Tensor? map1, Tensor? map2, float? slope, ScalarType out_dtype) -> Tensor")


def _present(*maps):
    return [m for m in maps if m is not None]


def _cuda(x, scale, shift, map0, map1, map2, slope, out_dtype):
    """The kernel, or an error."""
    return _launch(x, scale, shift, _present(map0, map1, map2), slope, out_dtype)


def _cpu(x, scale, shift, map0, map1, map2, slope, out_dtype):
    maps = _present(map0, map1, map2)
    _check(x, scale, shift, maps, out_dtype)
    y = norm_modulate_plain(x, scale, shift, maps, slope)
    return y.to(dtype=out_dtype, memory_format=torch.channels_last)


_LIB.impl("norm_modulate", _cuda, "CUDA")
_LIB.impl("norm_modulate", _cpu, "CPU")


@torch.library.register_fake("fsv::norm_modulate", lib=_LIB)
def _(x, scale, shift, map0, map1, map2, slope, out_dtype):
    _check(x, scale, shift, _present(map0, map1, map2), out_dtype)
    return torch.empty_like(x, dtype=out_dtype, memory_format=torch.channels_last)


norm_modulate_op = torch.ops.fsv.norm_modulate.default


def norm_modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                  maps: Sequence[torch.Tensor] = (),
                  slope: Optional[float] = None) -> torch.Tensor:
    """The fused route (the caller has checked `fused_route`): one call of
    fsv::norm_modulate, channels-last, in `served_dtype(x)`."""
    norm_modulate.calls_by_route["fused"] += 1
    m = list(maps) + [None] * (MAX_MAPS - len(maps))
    return norm_modulate_op(x, scale, shift, *m, slope, served_dtype(x))


# calls of each route (the plain ones are counted by the norms that take
# it), and the kernel's launches that returned no error
norm_modulate.calls_by_route = {"fused": 0, "plain": 0}
norm_modulate.launches = 0
