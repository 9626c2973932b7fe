# The benchmark's frozen copy of fsvid2vid_tpu_torch/ops/batch_conv.py, its imports
# pointed at this package: it imports nothing of the port.
"""Per-sample-weight convolution (port of fsvid2vid_tpu/ops/batch_conv.py).

The reference loops over the batch, one conv per sample
(models/networks/base_network.py:56-71); here the batch folds into the
groups of one grouped conv.  Weights keep torch's layout per sample:
(B, Cout, Cin, kh, kw), bias (B, Cout); padding is k // 2.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def batch_conv(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               stride: int = 1) -> torch.Tensor:
    """Convolve each sample of x (B, Cin, H, W) with its own kernel."""
    b, cin, h, w = x.shape
    _, cout, _, kh, kw = weight.shape
    y = F.conv2d(x.reshape(1, b * cin, h, w),
                 weight.reshape(b * cout, cin, kh, kw).to(x.dtype),
                 stride=stride, padding=kh // 2, groups=b)
    y = y.view(b, cout, y.shape[2], y.shape[3])
    if bias is not None:
        y = y + bias[:, :, None, None].to(y.dtype)
    return y
