"""The control of the correctness check: the reference computed in the
nearest precision below the one the configurations state (bf16), fp8.

Under `Fp8Operands` the operands of every convolution and matrix product,
and every activation (each floating result of two or more axes that is not
a view of an input), are rounded to float8_e4m3fn with a per-tensor scale
(the largest magnitude to 448, e4m3's largest normal): the program's bf16
autocast holds the same tensors in bf16.  In the backward the gradient
that reaches each rounded tensor is rounded to float8_e5m2 the same way,
as an fp8 training recipe does.  The arithmetic itself runs in the
operands' own dtype; scalars and vectors (losses, norm statistics,
biases) and the optimizer keep the reference's precision."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
E5M2_MAX = 57344.0

_PRODUCTS = {F.conv2d, F.conv_transpose2d, F.linear, torch.conv2d,
             torch.conv_transpose2d, torch.matmul, torch.mm, torch.bmm,
             torch.addmm, torch.baddbmm, torch.einsum, torch.Tensor.__matmul__,
             torch.Tensor.matmul, torch.Tensor.mm, torch.Tensor.bmm}


def _round(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = largest / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, E5M2_MAX)


def round_fp8(x):
    """x rounded to e4m3 under a per-tensor scale, in x's dtype; its
    gradient rounded to e5m2.  Anything but a floating tensor passes."""
    if not (isinstance(x, torch.Tensor) and x.is_floating_point()) or x.numel() == 0:
        return x
    return _Fp8.apply(x)


def _storages(args) -> set:
    out = set()
    for a in args:
        for t in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(t, torch.Tensor):
                out.add(t.untyped_storage().data_ptr())
    return out


def _activation(result, inputs: set):
    if (isinstance(result, torch.Tensor) and result.is_floating_point()
            and result.dim() >= 2 and result.untyped_storage().data_ptr() not in inputs):
        return round_fp8(result)
    return result


class Fp8Operands(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(round_fp8(a) if isinstance(a, torch.Tensor) else
                         ([round_fp8(t) for t in a] if isinstance(a, (list, tuple))
                          and a and isinstance(a[0], torch.Tensor) else a)
                         for a in args)
        result = func(*args, **kwargs)
        if getattr(func, "__name__", "").endswith("_"):
            return result   # an in-place op returns its input
        inputs = _storages(args) | _storages(kwargs.values())
        if type(result) is tuple:
            return tuple(_activation(r, inputs) for r in result)
        return _activation(result, inputs)


@contextlib.contextmanager
def no_tf32(torch=torch):
    """f32 products in f32: TF32 off (the reference's precision), restored
    after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
