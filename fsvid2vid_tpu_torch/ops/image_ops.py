"""Small image ops (port of fsvid2vid_tpu/ops/image_ops.py), NCHW."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample by an integer factor."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize to (H, W) with torch's floor(out_idx * in/out) source
    index, computed in f32 as the JAX op does."""
    h, w = x.shape[-2:]
    oh, ow = size
    if (oh, ow) == (h, w):
        return x
    ys = torch.floor(torch.arange(oh, device=x.device, dtype=torch.float32)
                     * (h / oh)).long()
    xs = torch.floor(torch.arange(ow, device=x.device, dtype=torch.float32)
                     * (w / ow)).long()
    return x[:, :, ys][:, :, :, xs]


def avg_pool(x: torch.Tensor, window: int, stride: int, padding: int,
             count_include_pad: bool = True) -> torch.Tensor:
    """Average pool; the zero padding is counted unless told otherwise
    (flax's default)."""
    return F.avg_pool2d(x, window, stride, padding,
                        count_include_pad=count_include_pad)


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
