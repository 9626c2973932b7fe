"""Per-sample-weight convolution (port of fsvid2vid_tpu/ops/batch_conv.py).

The reference loops over the batch, one conv per sample
(models/networks/base_network.py:56-71).  Weights keep torch's layout per
sample: (B, Cout, Cin, kh, kw), bias (B, Cout); padding is k // 2.  The
route follows what the call shows:

  matmul   a channels-last input with a 1 x 1, stride-1 kernel, in a call
           that autograd does not record (the served forward): one batched
           product (B, H*W, Cin) x (B, Cin, Cout), the bias folded in; the
           output is a channels-last view, so no copy or transpose
           surrounds it;
  grouped  every other call (NCHW inputs; k > 1; stride 2; every call of
           a training step, whose gradients keep the kernels they had): the
           batch folds into the groups of one grouped conv, NCHW.

`batch_conv.calls_by_route` counts the calls of each route.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from fsvid2vid_tpu_torch.ops.image_ops import channels_innermost, records_grad


def batch_conv(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               stride: int = 1) -> torch.Tensor:
    """Convolve each sample of x (B, Cin, H, W) with its own kernel."""
    b, cin, h, w = x.shape
    _, cout, _, kh, kw = weight.shape
    if (kh == kw == 1 and stride == 1 and channels_innermost(x)
            and not records_grad(x, weight, bias)):
        batch_conv.calls_by_route["matmul"] += 1
        rows = x.permute(0, 2, 3, 1).reshape(b, h * w, cin)
        wt = weight.reshape(b, cout, cin).transpose(1, 2).to(x.dtype)
        if bias is None:
            y = torch.bmm(rows, wt)
        else:
            y = torch.baddbmm(bias[:, None, :].to(x.dtype), rows, wt)
        return y.view(b, h, w, cout).permute(0, 3, 1, 2)
    batch_conv.calls_by_route["grouped"] += 1
    y = F.conv2d(x.reshape(1, b * cin, h, w),
                 weight.reshape(b * cout, cin, kh, kw).to(x.dtype),
                 stride=stride, padding=kh // 2, groups=b)
    y = y.view(b, cout, y.shape[2], y.shape[3])
    if bias is not None:
        y = y + bias[:, :, None, None].to(y.dtype)
    return y


batch_conv.calls_by_route = {"matmul": 0, "grouped": 0}
