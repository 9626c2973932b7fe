# The benchmark's frozen copy of fsvid2vid_tpu_torch/ops/crop.py, its imports
# pointed at this package: it imports nothing of the port.
"""Crop and resize a box per sample, and paste a patch back into its box, as
fixed-shape bilinear sampling (port of fsvid2vid_tpu/ops/crop.py; reference
models/face_refiner.py:33-51, which slices the variable-size face box and
resizes it with F.interpolate).

Channel-last like the JAX ops, plain differentiable torch.  The sampling
convention is the JAX package's, not F.grid_sample's nor F.interpolate's:
the output pixel i of a box [ys, ye) reads source row
ys + (i + 0.5) (ye - ys) / h - 0.5, clamped to the image, then split into
floor and fraction.
"""
from __future__ import annotations

import torch


def _bilinear_sample(image: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """Sample image (B, H, W, C) at float coordinates ys / xs (B, h, w),
    clamped to the border."""
    b, h, w, c = image.shape
    ys = ys.clamp(0.0, h - 1.0)
    xs = xs.clamp(0.0, w - 1.0)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = (ys - y0)[..., None], (xs - x0)[..., None]
    y0i, x0i = y0.long(), x0.long()
    y1i, x1i = (y0i + 1).clamp(max=h - 1), (x0i + 1).clamp(max=w - 1)
    flat = image.reshape(b, h * w, c)

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(*yi.shape, c)

    v00, v01 = gather(y0i, x0i), gather(y0i, x1i)
    v10, v11 = gather(y1i, x0i), gather(y1i, x1i)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11)).to(image.dtype)


def crop_resize(image: torch.Tensor, boxes: torch.Tensor, out_size) -> torch.Tensor:
    """Crop each sample's box and resize it to out_size bilinearly.

    image: (B, H, W, C); boxes: (B, 4) float [ys, ye, xs, xe) in pixels
    (exclusive end); out_size: (h, w).  Returns (B, h, w, C)."""
    b = image.shape[0]
    oh, ow = out_size
    boxes = boxes.float()
    ys, ye, xs, xe = boxes.unbind(1)
    gi = torch.arange(oh, dtype=torch.float32, device=image.device)
    gj = torch.arange(ow, dtype=torch.float32, device=image.device)
    yy = ys[:, None] + (gi[None] + 0.5) * ((ye - ys) / oh)[:, None] - 0.5
    xx = xs[:, None] + (gj[None] + 0.5) * ((xe - xs) / ow)[:, None] - 0.5
    return _bilinear_sample(image, yy[:, :, None].expand(b, oh, ow),
                            xx[:, None, :].expand(b, oh, ow))


def paste_region(canvas: torch.Tensor, patch: torch.Tensor,
                 boxes: torch.Tensor) -> torch.Tensor:
    """The inverse of crop_resize: `patch` (B, h, w, C) resized bilinearly
    into each sample's box of `canvas` (B, H, W, C); pixels outside the box
    keep the canvas's value."""
    b, h, w, _ = canvas.shape
    ph, pw = patch.shape[1:3]
    boxes = boxes.float()
    ys, ye, xs, xe = boxes.unbind(1)
    gi = torch.arange(h, dtype=torch.float32, device=canvas.device)
    gj = torch.arange(w, dtype=torch.float32, device=canvas.device)
    py = (gi[None] - ys[:, None] + 0.5) * (ph / (ye - ys))[:, None] - 0.5
    px = (gj[None] - xs[:, None] + 0.5) * (pw / (xe - xs))[:, None] - 0.5
    resized = _bilinear_sample(patch, py[:, :, None].expand(b, h, w),
                               px[:, None, :].expand(b, h, w))
    inside = ((gi[None, :, None] >= ys[:, None, None])
              & (gi[None, :, None] < ye[:, None, None])
              & (gj[None, None, :] >= xs[:, None, None])
              & (gj[None, None, :] < xe[:, None, None]))
    return torch.where(inside[..., None], resized, canvas)
