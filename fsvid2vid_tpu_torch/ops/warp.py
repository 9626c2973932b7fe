"""Bilinear backward warp by a pixel-space flow (port of
fsvid2vid_tpu/ops/warp.py::flow_warp) on (B, C, H, W) images.

  X = clip(x + u, 0, W-1), Y = clip(y + v, 0, H-1)
  out = (1-fy)((1-fx) I[Y0,X0] + fx I[Y0,X1]) + fy((1-fx) I[Y1,X0] + fx I[Y1,X1])

with X1 = min(X0+1, W-1), Y1 = min(Y0+1, H-1).  This equals
grid_sample(align_corners=True, padding_mode='border') on flow normalised by
(W-1)/2, (H-1)/2, which is how the reference warps.

The output keeps the image's layout outside autograd: an image whose
channels are its innermost dimension (channels-last, as in the served
forward) is gathered as (B, H*W, C) rows and warped channels-last; any
other, and every call of a training step, as (B, C, H*W) planes, NCHW.
"""
from __future__ import annotations

import torch

from fsvid2vid_tpu_torch.ops.image_ops import channels_innermost, records_grad


def flow_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp `image` (B, C, H, W) by `flow` (B, 2, H, W); flow
    channel 0 is the horizontal displacement u, channel 1 the vertical v."""
    b, c, h, w = image.shape
    fl = flow.float()
    xs = torch.arange(w, device=image.device, dtype=torch.float32).view(1, 1, w)
    ys = torch.arange(h, device=image.device, dtype=torch.float32).view(1, h, 1)
    x = (xs + fl[:, 0]).clamp(0.0, w - 1.0)
    y = (ys + fl[:, 1]).clamp(0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None].to(image.dtype)
    fy = (y - y0)[:, None].to(image.dtype)
    # a NaN in the flow leaves x0 / y0 NaN, whose integer value is undefined
    # (on the card a gather out of the image is a device-side assert): clamp
    # the indices, and the pixel comes out NaN through fx / fy, as in JAX
    x0i, y0i = x0.long().clamp(0, w - 1), y0.long().clamp(0, h - 1)
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    if channels_innermost(image) and not records_grad(image, flow):
        flat = image.permute(0, 2, 3, 1).reshape(b, h * w, c)

        def at(yi, xi):
            idx = (yi * w + xi).view(b, h * w, 1).expand(b, h * w, c)
            return flat.gather(1, idx).view(b, h, w, c).permute(0, 3, 1, 2)
    else:
        flat = image.reshape(b, c, h * w)

        def at(yi, xi):
            idx = (yi * w + xi).view(b, 1, h * w).expand(b, c, h * w)
            return flat.gather(2, idx).view(b, c, h, w)

    return ((1 - fy) * ((1 - fx) * at(y0i, x0i) + fx * at(y0i, x1i))
            + fy * ((1 - fx) * at(y1i, x0i) + fx * at(y1i, x1i)))
