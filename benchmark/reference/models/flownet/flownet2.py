# The benchmark's frozen copy of fsvid2vid_tpu_torch/models/flownet/flownet2.py, its imports
# pointed at this package: it imports nothing of the port.
"""FlowNet2 flow-estimation stack (port of
fsvid2vid_tpu/models/flownet/flownet2.py; reference
models/networks/flownet2_pytorch/), NCHW: FlowNetC (correlation cost volume)
-> two FlowNetS refinements + FlowNetSD, fused by FlowNetFusion; 162,518,834
parameters.  It is the frozen flow teacher of training.

Parameter names are the reference checkpoint's (`flownetc.conv1.0.weight`,
`flownets_1.deconv5.0.weight`, `flownetfusion.predict_flow0.bias`, ...), so
its state dict loads directly.  All convs have a bias and leaky(0.1)
(batchNorm=False in the reference); FlowNetS's flow upsamplers are bias-free.
On CUDA tensors the correlation runs the hand-written kernel
(ops/cost_volume.py).

The standalone variants of the family (FlowNet2C / 2S / 2SD / 2CS / 2CSS,
reference models.py:185-470) are here too, off the training path.  Their
sub-networks carry the cascade's names (`flownetc`, `flownets_1`, ...), so a
FlowNet2 state dict loads into 2C, 2CS and 2CSS by name.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.ops.correlation import correlation
from benchmark.reference.ops.image_ops import (
    channel_norm, upsample_bilinear, upsample_nearest)
from benchmark.reference.ops.warp import flow_warp


def conv(cin: int, cout: int, kernel_size: int = 3, stride: int = 1) -> nn.Sequential:
    """conv + leaky(0.1) (reference submodules.py:7-18)."""
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel_size, stride, (kernel_size - 1) // 2),
        nn.LeakyReLU(0.1))


def i_conv(cin: int, cout: int) -> nn.Sequential:
    """conv without activation (reference submodules.py:20-29)."""
    return nn.Sequential(nn.Conv2d(cin, cout, 3, 1, 1))


def deconv(cin: int, cout: int) -> nn.Sequential:
    """transposed conv + leaky(0.1) (reference submodules.py:34-38)."""
    return nn.Sequential(nn.ConvTranspose2d(cin, cout, 4, 2, 1), nn.LeakyReLU(0.1))


def predict_flow(cin: int) -> nn.Conv2d:
    return nn.Conv2d(cin, 2, 3, 1, 1)


def flow_upsampler(bias: bool = True) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(2, 2, 4, 2, 1, bias=bias)


class _Decoder(nn.Module):
    """The refinement decoder FlowNetC and FlowNetS share: from out6 down to
    the quarter-resolution flow2."""

    def _init_decoder(self, upsampler_bias: bool):
        self.deconv5 = deconv(1024, 512)
        self.deconv4 = deconv(1026, 256)
        self.deconv3 = deconv(770, 128)
        self.deconv2 = deconv(386, 64)
        self.predict_flow6 = predict_flow(1024)
        self.predict_flow5 = predict_flow(1026)
        self.predict_flow4 = predict_flow(770)
        self.predict_flow3 = predict_flow(386)
        self.predict_flow2 = predict_flow(194)
        for name in ("6_to_5", "5_to_4", "4_to_3", "3_to_2"):
            setattr(self, f"upsampled_flow{name}", flow_upsampler(upsampler_bias))

    def _decode(self, out6, out5, out4, out3, out2):
        flow6 = self.predict_flow6(out6)
        concat5 = torch.cat([out5, self.deconv5(out6),
                             self.upsampled_flow6_to_5(flow6)], 1)
        flow5 = self.predict_flow5(concat5)
        concat4 = torch.cat([out4, self.deconv4(concat5),
                             self.upsampled_flow5_to_4(flow5)], 1)
        flow4 = self.predict_flow4(concat4)
        concat3 = torch.cat([out3, self.deconv3(concat4),
                             self.upsampled_flow4_to_3(flow4)], 1)
        flow3 = self.predict_flow3(concat3)
        concat2 = torch.cat([out2, self.deconv2(concat3),
                             self.upsampled_flow3_to_2(flow3)], 1)
        return self.predict_flow2(concat2)


class FlowNetC(_Decoder):
    """39,175,298 parameters."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2)
        self.conv2 = conv(64, 128, 5, 2)
        self.conv3 = conv(128, 256, 5, 2)
        self.conv_redir = conv(256, 32, 1)
        self.conv3_1 = conv(473, 256)
        self.conv4 = conv(256, 512, 3, 2)
        self.conv4_1 = conv(512, 512)
        self.conv5 = conv(512, 512, 3, 2)
        self.conv5_1 = conv(512, 512)
        self.conv6 = conv(512, 1024, 3, 2)
        self.conv6_1 = conv(1024, 1024)
        self._init_decoder(upsampler_bias=True)

    def forward(self, x1, x2):
        a2 = self.conv2(self.conv1(x1))
        a3 = self.conv3(a2)
        b3 = self.conv3(self.conv2(self.conv1(x2)))
        corr = F.leaky_relu(correlation(a3.contiguous(), b3.contiguous(),
                                        max_displacement=20, stride=2), 0.1)
        out3 = self.conv3_1(torch.cat([self.conv_redir(a3), corr], 1))
        out4 = self.conv4_1(self.conv4(out3))
        out5 = self.conv5_1(self.conv5(out4))
        out6 = self.conv6_1(self.conv6(out5))
        return self._decode(out6, out5, out4, out3, a2)


class FlowNetS(_Decoder):
    """38,695,322 parameters; the flow upsamplers are bias-free."""

    def __init__(self, input_channels: int = 12):
        super().__init__()
        self.conv1 = conv(input_channels, 64, 7, 2)
        self.conv2 = conv(64, 128, 5, 2)
        self.conv3 = conv(128, 256, 5, 2)
        self.conv3_1 = conv(256, 256)
        self.conv4 = conv(256, 512, 3, 2)
        self.conv4_1 = conv(512, 512)
        self.conv5 = conv(512, 512, 3, 2)
        self.conv5_1 = conv(512, 512)
        self.conv6 = conv(512, 1024, 3, 2)
        self.conv6_1 = conv(1024, 1024)
        self._init_decoder(upsampler_bias=False)

    def forward(self, x):
        out2 = self.conv2(self.conv1(x))
        out3 = self.conv3_1(self.conv3(out2))
        out4 = self.conv4_1(self.conv4(out3))
        out5 = self.conv5_1(self.conv5(out4))
        out6 = self.conv6_1(self.conv6(out5))
        return self._decode(out6, out5, out4, out3, out2)


class FlowNetSD(nn.Module):
    """45,371,666 parameters."""

    def __init__(self):
        super().__init__()
        self.conv0 = conv(6, 64)
        self.conv1 = conv(64, 64, 3, 2)
        self.conv1_1 = conv(64, 128)
        self.conv2 = conv(128, 128, 3, 2)
        self.conv2_1 = conv(128, 128)
        self.conv3 = conv(128, 256, 3, 2)
        self.conv3_1 = conv(256, 256)
        self.conv4 = conv(256, 512, 3, 2)
        self.conv4_1 = conv(512, 512)
        self.conv5 = conv(512, 512, 3, 2)
        self.conv5_1 = conv(512, 512)
        self.conv6 = conv(512, 1024, 3, 2)
        self.conv6_1 = conv(1024, 1024)
        self.deconv5 = deconv(1024, 512)
        self.deconv4 = deconv(1026, 256)
        self.deconv3 = deconv(770, 128)
        self.deconv2 = deconv(386, 64)
        self.inter_conv5 = i_conv(1026, 512)
        self.inter_conv4 = i_conv(770, 256)
        self.inter_conv3 = i_conv(386, 128)
        self.inter_conv2 = i_conv(194, 64)
        self.predict_flow6 = predict_flow(1024)
        self.predict_flow5 = predict_flow(512)
        self.predict_flow4 = predict_flow(256)
        self.predict_flow3 = predict_flow(128)
        self.predict_flow2 = predict_flow(64)
        for name in ("6_to_5", "5_to_4", "4_to_3", "3_to_2"):
            setattr(self, f"upsampled_flow{name}", flow_upsampler())

    def forward(self, x):
        out0 = self.conv0(x)
        out1 = self.conv1_1(self.conv1(out0))
        out2 = self.conv2_1(self.conv2(out1))
        out3 = self.conv3_1(self.conv3(out2))
        out4 = self.conv4_1(self.conv4(out3))
        out5 = self.conv5_1(self.conv5(out4))
        out6 = self.conv6_1(self.conv6(out5))

        flow6 = self.predict_flow6(out6)
        concat5 = torch.cat([out5, self.deconv5(out6),
                             self.upsampled_flow6_to_5(flow6)], 1)
        flow5 = self.predict_flow5(self.inter_conv5(concat5))
        concat4 = torch.cat([out4, self.deconv4(concat5),
                             self.upsampled_flow5_to_4(flow5)], 1)
        flow4 = self.predict_flow4(self.inter_conv4(concat4))
        concat3 = torch.cat([out3, self.deconv3(concat4),
                             self.upsampled_flow4_to_3(flow4)], 1)
        flow3 = self.predict_flow3(self.inter_conv3(concat3))
        concat2 = torch.cat([out2, self.deconv2(concat3),
                             self.upsampled_flow3_to_2(flow3)], 1)
        return self.predict_flow2(self.inter_conv2(concat2))


class FlowNetFusion(nn.Module):
    """581,226 parameters."""

    def __init__(self):
        super().__init__()
        self.conv0 = conv(11, 64)
        self.conv1 = conv(64, 64, 3, 2)
        self.conv1_1 = conv(64, 128)
        self.conv2 = conv(128, 128, 3, 2)
        self.conv2_1 = conv(128, 128)
        self.deconv1 = deconv(128, 32)
        self.deconv0 = deconv(162, 16)
        self.inter_conv1 = i_conv(162, 32)
        self.inter_conv0 = i_conv(82, 16)
        self.predict_flow2 = predict_flow(128)
        self.predict_flow1 = predict_flow(32)
        self.predict_flow0 = predict_flow(16)
        self.upsampled_flow2_to_1 = flow_upsampler()
        self.upsampled_flow1_to_0 = flow_upsampler()

    def forward(self, x):
        out0 = self.conv0(x)
        out1 = self.conv1_1(self.conv1(out0))
        out2 = self.conv2_1(self.conv2(out1))
        flow2 = self.predict_flow2(out2)
        concat1 = torch.cat([out1, self.deconv1(out2),
                             self.upsampled_flow2_to_1(flow2)], 1)
        flow1 = self.predict_flow1(self.inter_conv1(concat1))
        concat0 = torch.cat([out0, self.deconv0(concat1),
                             self.upsampled_flow1_to_0(flow1)], 1)
        return self.predict_flow0(self.inter_conv0(concat0))


def refine_input(x1, x2, flow, div_flow: float):
    """A FlowNetS stage's 12 channels: both frames, the second warped by
    `flow`, the flow over div_flow and the warp's error norm."""
    warped = flow_warp(x2, flow)
    return torch.cat([x1, x2, warped, flow / div_flow, channel_norm(x1 - warped)], 1)


def rgb_norm(im1, im2, rgb_max: float):
    """Both frames less their per-(sample, channel) mean over both frames,
    over rgb_max (JAX `_RgbNorm`)."""
    rgb_mean = torch.stack([im1, im2], 1).mean((1, 3, 4), keepdim=True)[:, 0]
    return (im1 - rgb_mean) / rgb_max, (im2 - rgb_mean) / rgb_max


class FlowNet2(nn.Module):
    """The full cascade (reference models.py:116-182).  im1, im2:
    (B, 3, H, W) with H, W multiples of 64; returns the pixel-space flow
    (B, 2, H, W)."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 1.0):
        super().__init__()
        self.div_flow = div_flow
        self.rgb_max = rgb_max
        self.flownetc = FlowNetC()
        self.flownets_1 = FlowNetS()
        self.flownets_2 = FlowNetS()
        self.flownets_d = FlowNetSD()
        self.flownetfusion = FlowNetFusion()

    def forward(self, im1, im2):
        x1, x2 = rgb_norm(im1, im2, self.rgb_max)
        c_flow = upsample_bilinear(self.flownetc(x1, x2) * self.div_flow, 4)
        s1_flow2 = self.flownets_1(refine_input(x1, x2, c_flow, self.div_flow))
        s1_flow = upsample_bilinear(s1_flow2 * self.div_flow, 4)
        s2_flow2 = self.flownets_2(refine_input(x1, x2, s1_flow, self.div_flow))
        s2_flow = upsample_nearest(s2_flow2 * self.div_flow, 4)
        diff_s2 = channel_norm(x1 - flow_warp(x2, s2_flow))

        sd_flow2 = self.flownets_d(torch.cat([x1, x2], 1))
        sd_flow = upsample_nearest(sd_flow2 / self.div_flow, 4)
        diff_sd = channel_norm(x1 - flow_warp(x2, sd_flow))

        return self.flownetfusion(torch.cat(
            [x1, sd_flow, s2_flow, channel_norm(sd_flow), channel_norm(s2_flow),
             diff_sd, diff_s2], 1))


# ---------------------------------------------------------------------------
# The standalone sub-variants (JAX flownet2.py:311-396, reference
# models.py:185-470).  Each takes (im1, im2) in [0, rgb_max], (B, 3, H, W)
# with H, W multiples of 64, and returns the quarter-resolution flow scaled
# by div_flow and upsampled x4, bilinearly but for FlowNet2CSS's last head,
# which is nearest (reference models.py:451 upsample3).
# ---------------------------------------------------------------------------

class _Variant(nn.Module):
    def __init__(self, div_flow: float = 20.0, rgb_max: float = 1.0):
        super().__init__()
        self.div_flow = div_flow
        self.rgb_max = rgb_max


class FlowNet2C(_Variant):
    """FlowNetC alone; one B2 launch per call on CUDA."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 1.0):
        super().__init__(div_flow, rgb_max)
        self.flownetc = FlowNetC()

    def forward(self, im1, im2):
        x1, x2 = rgb_norm(im1, im2, self.rgb_max)
        return upsample_bilinear(self.flownetc(x1, x2) * self.div_flow, 4)


class FlowNet2S(_Variant):
    """FlowNetS on the 6 channels of both frames."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 1.0):
        super().__init__(div_flow, rgb_max)
        self.flownets = FlowNetS(input_channels=6)

    def forward(self, im1, im2):
        x1, x2 = rgb_norm(im1, im2, self.rgb_max)
        return upsample_bilinear(self.flownets(torch.cat([x1, x2], 1)) * self.div_flow, 4)


class FlowNet2SD(_Variant):
    """FlowNetSD alone, for small displacements."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 1.0):
        super().__init__(div_flow, rgb_max)
        self.flownets_d = FlowNetSD()

    def forward(self, im1, im2):
        x1, x2 = rgb_norm(im1, im2, self.rgb_max)
        return upsample_bilinear(self.flownets_d(torch.cat([x1, x2], 1)) * self.div_flow, 4)


class FlowNet2CS(_Variant):
    """FlowNetC, a warp, then one FlowNetS refinement (models.py:350-413)."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 1.0):
        super().__init__(div_flow, rgb_max)
        self.flownetc = FlowNetC()
        self.flownets_1 = FlowNetS()

    def _stage1(self, x1, x2):
        c_flow = upsample_bilinear(self.flownetc(x1, x2) * self.div_flow, 4)
        s1_flow2 = self.flownets_1(refine_input(x1, x2, c_flow, self.div_flow))
        return upsample_bilinear(s1_flow2 * self.div_flow, 4)

    def forward(self, im1, im2):
        return self._stage1(*rgb_norm(im1, im2, self.rgb_max))


class FlowNet2CSS(FlowNet2CS):
    """FlowNet2CS and a second FlowNetS stage (models.py:415-470), whose
    head upsamples nearest."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 1.0):
        super().__init__(div_flow, rgb_max)
        self.flownets_2 = FlowNetS()

    def forward(self, im1, im2):
        x1, x2 = rgb_norm(im1, im2, self.rgb_max)
        s1_flow = self._stage1(x1, x2)
        s2_flow2 = self.flownets_2(refine_input(x1, x2, s1_flow, self.div_flow))
        return upsample_nearest(s2_flow2 * self.div_flow, 4)


VARIANTS = {"FlowNet2C": FlowNet2C, "FlowNet2S": FlowNet2S, "FlowNet2SD": FlowNet2SD,
            "FlowNet2CS": FlowNet2CS, "FlowNet2CSS": FlowNet2CSS}
