"""Networks of the port and their seeded initialisation.  `build_generator`
is the counterpart of the G half of
fsvid2vid_tpu/training/state.py::build_models; training/state.py builds the
rest."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from fsvid2vid_tpu_torch import resolve_device
from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.models.generator import FewShotGenerator
from fsvid2vid_tpu_torch.models.layers import (
    InstanceNorm, SyncBatchNorm, _SpectralNormed)
from fsvid2vid_tpu_torch.ops.spectral_norm import power_iteration

SN_INIT_POWER_ITERS = 10


def _xavier(shape, gain, generator):
    """torch init.xavier_normal_ on an (out, in, *k) shape, on the CPU."""
    rf = math.prod(shape[2:])
    std = gain * math.sqrt(2.0 / (shape[1] * rf + shape[0] * rf))
    return torch.randn(shape, generator=generator) * std


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator,
                 gain: float = 0.02) -> nn.Module:
    """The reference's 'xavier' init (base_network.py:96-99): xavier-normal
    conv and linear weights with gain `gain`, zero biases, batch-norm scales ~ N(1, gain),
    running statistics 0 / 1.  Spectral-norm u / v start from random vectors
    refined by a few power iterations.  Draws on the CPU from `generator`,
    so a seed gives the same weights on every device."""
    for m in model.modules():
        tensors = {}
        if isinstance(m, _SpectralNormed):
            w = _xavier(tuple((m.weight_orig if m.use_sn else m.weight).shape),
                        gain, generator)
            if m.use_sn:
                u0 = torch.randn(w.shape[0], generator=generator)
                u, v = power_iteration(w, u0 / u0.norm(), SN_INIT_POWER_ITERS)
                tensors.update(weight_orig=w, weight_u=u, weight_v=v)
                m.folded = False
            else:
                tensors["weight"] = w
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            tensors["weight"] = _xavier(tuple(m.weight.shape), gain, generator)
        elif isinstance(m, SyncBatchNorm):
            n = m.running_mean.shape[0]
            tensors.update(running_mean=torch.zeros(n), running_var=torch.ones(n),
                           num_batches_tracked=torch.zeros((), dtype=torch.long))
            if m.weight is not None:
                tensors["weight"] = 1.0 + gain * torch.randn(n, generator=generator)
        elif isinstance(m, InstanceNorm) and m.weight is not None:
            tensors["weight"] = torch.ones(m.weight.shape)
        if getattr(m, "bias", None) is not None:
            tensors["bias"] = torch.zeros(m.bias.shape)
        for name, t in tensors.items():
            getattr(m, name).copy_(t)
    return model


@torch.no_grad()
def init_plain_convs(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init of a network of plain convs (VGG19, FlowNet2) that stands
    in for pretrained weights, with flax's defaults as the JAX package uses
    them: conv weights ~ N(0, 1 / fan_in), transposed-conv weights xavier
    uniform, zero biases.  Draws on the CPU from `generator`."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * math.prod(m.kernel_size)
            w = torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in)
        elif isinstance(m, nn.ConvTranspose2d):
            rf = math.prod(m.kernel_size)
            limit = math.sqrt(6.0 / (rf * (m.in_channels + m.out_channels)))
            w = (torch.rand(m.weight.shape, generator=generator) * 2 - 1) * limit
        else:
            continue
        m.weight.copy_(w)
        if m.bias is not None:
            m.bias.zero_()
    return model


def build_on_device(make, device) -> nn.Module:
    """`make()` built without storage, then given uninitialised storage on
    `device`: the caller initialises every parameter and buffer."""
    with torch.device("meta"):
        net = make()
    return net.to_empty(device=device)


def build_generator(cfg: Config, device=None,
                    generator: Optional[torch.Generator] = None) -> FewShotGenerator:
    """The generator of `cfg` in eval mode on `device` (CUDA unless the
    caller names another device), initialised from `generator` (a CPU
    torch.Generator; seed cfg.seed when None) with gain cfg.init_variance."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    net = build_on_device(lambda: FewShotGenerator(cfg), device)
    return init_weights(net, generator, cfg.init_variance).eval()
