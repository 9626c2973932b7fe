"""Flow estimation network (port of fsvid2vid_tpu/models/flow_generator.py,
reference generator.py:456-504), plain layout (no space-to-depth), on
(B, C, H, W) maps in the memory layout they come in; `cat_channels` joins
the inputs so that a channels-last one stays channels-last.

Input: the current label concatenated with n_frames_G - 1 previous labels
and images (for the reference branch: the reference label and image).
Output: a 2-channel pixel-space flow scaled by `flow_multiplier` and a
sigmoid occlusion mask.  The Sequential layouts reproduce the reference's
torch names: `down_flow.{2j}.{0,1}`, `res_flow.{j}`, `up_flow.{3j+1}.{0,1}`,
`conv_flow.0` and `conv_mask.0`.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.models.embedder import channel_schedule
from fsvid2vid_tpu_torch.models.layers import (
    SNConv, SpadeResnetBlock, make_plain_norm)
from fsvid2vid_tpu_torch.ops.image_ops import Upsample, cat_channels


class FlowGenerator(nn.Module):
    def __init__(self, cfg: Config, n_frames_G: int = 2):
        super().__init__()
        nf, nd, norm = cfg.nff, cfg.n_downsample_F, cfg.norm_F
        use_sn = "spectral" in norm
        ch = channel_schedule(nf, nd)
        input_nc = cfg.gen_input_nc * n_frames_G + cfg.output_nc * (n_frames_G - 1)
        self.flow_multiplier = cfg.flow_multiplier

        def conv_norm(cin, cout, stride=1):
            layers = [SNConv(cin, cout, 3, stride, bias=False, use_sn=use_sn)]
            plain = make_plain_norm(norm, cout)
            if plain is not None:
                layers.append(plain)
            return nn.Sequential(*layers)

        def act():
            return nn.LeakyReLU(0.2)

        down = [conv_norm(input_nc, nf), act()]
        for i in range(nd):
            down += [conv_norm(ch[i], ch[i + 1], stride=2), act()]
        self.down_flow = nn.Sequential(*down)
        self.res_flow = nn.Sequential(*[
            SpadeResnetBlock(ch[nd], ch[nd], norm=norm)
            for _ in range(cfg.n_blocks_F)])
        up = []
        for i in reversed(range(nd)):
            up += [Upsample(2), conv_norm(ch[i + 1], ch[i]), act()]
        self.up_flow = nn.Sequential(*up)
        self.conv_flow = nn.Sequential(nn.Conv2d(nf, 2, 3, padding=1))
        self.conv_mask = nn.Sequential(nn.Conv2d(nf, 1, 3, padding=1))

    def forward(self, label, label_prev, img_prev):
        """label: (B, Cl, H, W); label_prev / img_prev: the previous frames
        stacked on channels.  Returns (flow (B, 2, H, W), mask (B, 1, H, W))."""
        h = self.down_flow(cat_channels([label, label_prev, img_prev]))
        h = self.up_flow(self.res_flow(h))
        flow = self.conv_flow(h) * self.flow_multiplier
        mask = torch.sigmoid(self.conv_mask(h))
        return flow, mask
