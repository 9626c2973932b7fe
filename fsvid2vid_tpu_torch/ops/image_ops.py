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


def avg_pool(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """Average pool with the zero padding counted (flax's default)."""
    return F.avg_pool2d(x, window, stride, padding)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """actvn (reference architecture.py:15-17)."""
    return F.leaky_relu(x, slope)
