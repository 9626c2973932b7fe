"""Label / warped-image embedding pyramids (port of
fsvid2vid_tpu/models/embedder.py, reference generator.py:506-572) on
(B, C, H, W) maps in the layout they come in (channels-last in the served
forward).

Torch names follow the reference's Sequential wrappers: `conv_first.0`,
`down_{i}.0` and `up_{i}.1` (behind an Upsample at index 0).  The first
`params_free_layers` decoder levels use per-sample generated weights
instead of owned convs and have no parameters.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from fsvid2vid_tpu_torch.ops.batch_conv import batch_conv
from fsvid2vid_tpu_torch.ops.image_ops import Upsample, leaky_relu, upsample_nearest


def channel_schedule(nf: int, n: int, nf_max: int = 1024):
    """ch = [min(nf_max, nf * 2**i)] (reference generator.py:29,520)."""
    return [min(nf_max, nf * (2 ** i)) for i in range(n + 1)]


class LabelEmbedder(nn.Module):
    def __init__(self, input_nc: int, arch: str = "encoderdecoder",
                 nf: int = 32, n_downsample: int = 5,
                 params_free_layers: int = 0):
        super().__init__()
        self.unet = "unet" in arch
        self.decode = "decoder" in arch or self.unet
        self.nd = n_downsample
        self.params_free_layers = params_free_layers
        ch = channel_schedule(nf, n_downsample)
        self.conv_first = nn.Sequential(nn.Conv2d(input_nc, nf, 3, padding=1))
        for i in range(n_downsample):
            if i >= params_free_layers or self.decode:
                setattr(self, f"down_{i}", nn.Sequential(
                    nn.Conv2d(ch[i], ch[i + 1], 3, stride=2, padding=1)))
        if self.decode:
            for i in range(n_downsample):
                if i >= params_free_layers:
                    cin = ch[i + 1] * (2 if self.unet and i != n_downsample - 1 else 1)
                    setattr(self, f"up_{i}", nn.Sequential(
                        Upsample(2),
                        nn.Conv2d(cin, ch[i], 3, padding=1)))

    def forward(self, x: Optional[torch.Tensor],
                weights: Optional[Sequence] = None):
        """Returns [level 0 .. n_downsample], level i at 1/2^i resolution
        with ch[i] channels.  weights[i] = (weight (B, Cout, Cin, k, k),
        bias (B, Cout) or None) for the generated levels."""
        if x is None:
            return None
        nd = self.nd
        out = [leaky_relu(self.conv_first(x))]
        for i in range(nd):
            if i >= self.params_free_layers or self.decode:
                h = leaky_relu(getattr(self, f"down_{i}")(out[-1]))
            else:
                h = leaky_relu(batch_conv(out[-1], weights[i][0],
                                          weights[i][1], stride=2))
            out.append(h)
        if not self.decode:
            return out
        if not self.unet:
            out = [out[-1]]
        for i in reversed(range(nd)):
            h = out[-1]
            if self.unet and i != nd - 1:
                h = torch.cat([h, out[i + 1]], 1)
            if i >= self.params_free_layers:
                h = leaky_relu(getattr(self, f"up_{i}")(h))
            else:
                h = leaky_relu(batch_conv(upsample_nearest(h), weights[i][0],
                                          weights[i][1]))
            out.append(h)
        if self.unet:
            out = out[nd:]
        return out[::-1]
