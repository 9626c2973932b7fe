"""Small image ops (port of fsvid2vid_tpu/ops/image_ops.py) on (B, C, H, W)
maps, NCHW or, in the served forward, channels-last.  `cat_channels`,
`resize_nearest` and `upsample_nearest` (and ops/warp.py, ops/batch_conv.py)
keep a channels-last layout in calls that autograd does not record
(`channels_innermost`, `records_grad`); a training step keeps the NCHW
forms it had, so its kernels and gradients stay its own.  The elementwise
ops keep either layout by themselves."""
from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F


def channels_innermost(x: torch.Tensor) -> bool:
    """(B, C, H, W) laid out channels-last: more than one channel, and the
    channels adjacent in memory."""
    return x.shape[1] > 1 and x.stride(1) == 1


def records_grad(*tensors) -> bool:
    """Autograd records an operation on these tensors (a training step)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


@functools.lru_cache(maxsize=None)
def _interpolate_dtype(device_type: str, dtype: torch.dtype, autocast: bool,
                       autocast_dtype: torch.dtype) -> torch.dtype:
    """The dtype F.interpolate gives a map of `dtype` under this autocast
    state: autocast runs it in float32 on some devices (CUDA) and leaves it
    on others.  Asked once of a one-pixel map."""
    one = torch.zeros((1, 1, 1, 1), dtype=dtype, device=device_type)
    return F.interpolate(one, scale_factor=2, mode="nearest").dtype


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample by an integer factor, as F.interpolate
    gives it, in its dtype.  A channels-last map outside autograd (the
    served forward) is written as one broadcast copy of its (B, H, W, C)
    rows, channels-last: the same values, without the per-element index
    arithmetic of the NHWC upsample kernel."""
    if not channels_innermost(x) or records_grad(x):
        return F.interpolate(x, scale_factor=factor, mode="nearest")
    b, c, h, w = x.shape
    dev = x.device.type
    dtype = _interpolate_dtype(dev, x.dtype, torch.is_autocast_enabled(dev),
                               torch.get_autocast_dtype(dev))
    out = torch.empty((b, h, factor, w, factor, c), dtype=dtype, device=x.device)
    out.copy_(x.permute(0, 2, 3, 1)[:, :, None, :, None, :].expand_as(out))
    return out.view(b, h * factor, w * factor, c).permute(0, 3, 1, 2)


class Upsample(nn.Module):
    """nn.Upsample(scale_factor) in nearest mode through `upsample_nearest`
    (no parameters: it holds a place in the reference's Sequential names)."""

    def __init__(self, scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor

    def forward(self, x):
        return upsample_nearest(x, self.scale_factor)


def cat_channels(xs) -> torch.Tensor:
    """torch.cat(xs, 1), laid out channels-last where an input is and
    autograd records none (the served forward): the maps are joined as
    (B, H, W, C) views, so a map of one channel, whose layout its strides
    leave open, does not turn the result NCHW.  Otherwise torch.cat."""
    if any(channels_innermost(x) for x in xs) and not records_grad(*xs):
        return torch.cat([x.movedim(1, -1) for x in xs], -1).movedim(-1, 1)
    return torch.cat(xs, 1)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize to (H, W) with torch's floor(out_idx * in/out) source
    index, computed in f32 as the JAX op does.  A channels-last map outside
    autograd stays channels-last."""
    h, w = x.shape[-2:]
    oh, ow = size
    if (oh, ow) == (h, w):
        return x
    ys = torch.floor(torch.arange(oh, device=x.device, dtype=torch.float32)
                     * (h / oh)).long()
    xs = torch.floor(torch.arange(ow, device=x.device, dtype=torch.float32)
                     * (w / ow)).long()
    if channels_innermost(x) and not records_grad(x):   # rows of (B, H, W, C)
        return x.permute(0, 2, 3, 1).index_select(1, ys).index_select(2, xs).permute(0, 3, 1, 2)
    return x[:, :, ys][:, :, :, xs]


def avg_pool(x: torch.Tensor, window: int, stride: int, padding: int,
             count_include_pad: bool = True) -> torch.Tensor:
    """Average pool; the zero padding is counted unless told otherwise
    (flax's default)."""
    return F.avg_pool2d(x, window, stride, padding,
                        count_include_pad=count_include_pad)


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """AdaptiveAvgPool2d of (B, C, H, W) to out_hw = (oh, ow): each output
    cell is the mean over torch's buckets [floor(i H / oh), ceil((i + 1) H /
    oh)) of rows and likewise of columns, which overlap where a size does not
    divide and where the map is smaller than the output (JAX
    `adaptive_avg_pool`)."""
    return F.adaptive_avg_pool2d(x, tuple(out_hw))


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """Max pool with -inf padding (torch MaxPool2d semantics)."""
    return F.max_pool2d(x, window, stride, padding)


def channel_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-pixel L2 norm over channels in f32, (B, C, H, W) -> (B, 1, H, W)."""
    return x.float().square().sum(1, keepdim=True).sqrt().to(x.dtype)


def _bilinear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) interpolation matrix of jax.image.resize's "bilinear":
    half-pixel centres and a triangle kernel that widens by n_in / n_out when
    shrinking (antialiasing); taps outside the input are dropped and the rest
    renormalised, which for enlarging equals clamping to the edge."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, device=device, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    taps = torch.arange(n_in, device=device, dtype=torch.float32)
    w = (1.0 - (sample[:, None] - taps[None, :]).abs() / kernel_scale).clamp(min=0.0)
    return w / w.sum(1, keepdim=True)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to `size` with the JAX package's
    semantics (jax.image.resize: antialiased when shrinking, unlike
    F.interpolate's default), computed in f32 as two small matrix products."""
    h, w = x.shape[-2:]
    oh, ow = size
    if (oh, ow) == (h, w):
        return x
    y = x.float()
    if oh != h:
        y = torch.einsum("oh,bchw->bcow", _bilinear_weights(h, oh, x.device), y)
    if ow != w:
        y = torch.einsum("pw,bchw->bchp", _bilinear_weights(w, ow, x.device), y)
    return y.to(x.dtype)


def upsample_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Bilinear upsample by an integer factor (half-pixel centres)."""
    return resize_bilinear(x, (x.shape[-2] * factor, x.shape[-1] * factor))


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """actvn (reference architecture.py:15-17)."""
    return F.leaky_relu(x, slope)
