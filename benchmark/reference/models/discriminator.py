# The benchmark's frozen copy of fsvid2vid_tpu_torch/models/discriminator.py, its imports
# pointed at this package: it imports nothing of the port.
"""PatchGAN discriminators (port of fsvid2vid_tpu/models/discriminator.py,
reference models/networks/discriminator.py), NCHW.

* `NLayerDiscriminator`: stride-2 conv PatchGAN, kernel 4, padding 2,
  spectral + instance norm on the middle layers, returning every layer's
  activation for the feature-matching loss.  Layer 0 and the logit conv are
  plain convs, as in the reference.
* `AdaptiveDiscriminator`: its first `adaptive_layers` convs take kernels
  generated per sample from the reference (`encoder_<n>`: a plain stride-2
  conv and leaky ReLU on the reference; `fc_<n>`: a linear layer on each
  channel of that map pooled to `ref_pool`), run through batch_conv and
  followed by an instance norm without affine (eps 1e-5) and leaky ReLU;
  then the fixed layers `model<n>` from n = adaptive_layers on, the logit
  conv spectral-normed too, as the JAX module has it.
* `MultiscaleDiscriminator`: num_D copies on an avg-pool(3, 2, 1,
  count_include_pad=False) pyramid; the adaptive copies take the reference,
  pooled between scales with the input.

Parameter names are the reference's: `discriminator_{i}.model{n}.0.*` for
the first and last layers and `discriminator_{i}.model{n}.0.0.*` (conv) /
`.0.1.*` (norm) for the middle ones; `discriminator_{i}.encoder_{n}.*` and
`.fc_{n}.*` for the adaptive layers' generators.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from benchmark.reference.models.layers import InstanceNorm, SNConv, make_plain_norm
from benchmark.reference.ops.batch_conv import batch_conv
from benchmark.reference.ops.image_ops import adaptive_avg_pool, avg_pool, leaky_relu

SUBARCHS = ("n_layers", "adaptive")


def _fixed_layer(nf_prev: int, nf: int, stride: int, norm: str, use_sn: bool):
    """A middle layer: Sequential(Sequential(conv, norm), leaky ReLU)."""
    block = [SNConv(nf_prev, nf, 4, stride, bias=False, use_sn=use_sn)]
    plain = make_plain_norm(norm, nf)
    if plain is not None:
        block.append(plain)
    return nn.Sequential(nn.Sequential(*block), nn.LeakyReLU(0.2))


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 4,
                 norm: str = "spectralinstance", get_interm_feat: bool = True,
                 stride: int = 2):
        super().__init__()
        self.n_layers = n_layers
        self.get_interm_feat = get_interm_feat
        use_sn = "spectral" in norm
        kw = 4
        self.model0 = nn.Sequential(
            SNConv(input_nc, ndf, kw, stride, use_sn=False), nn.LeakyReLU(0.2))
        nf = ndf
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, min(nf * 2, 512)
            setattr(self, f"model{n}", _fixed_layer(
                nf_prev, nf, stride if n != n_layers else 1, norm, use_sn))
        setattr(self, f"model{n_layers + 1}",
                nn.Sequential(SNConv(nf, 1, kw, 1, use_sn=False)))

    def forward(self, x):
        res = [x]
        for n in range(self.n_layers + 2):
            res.append(getattr(self, f"model{n}")(res[-1]))
        return res[1:] if self.get_interm_feat else res[-1]


class AdaptiveDiscriminator(nn.Module):
    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 4,
                 norm: str = "spectralinstance", get_interm_feat: bool = True,
                 adaptive_layers: int = 1, ref_pool=(4, 4)):
        super().__init__()
        self.n_layers = n_layers
        self.get_interm_feat = get_interm_feat
        self.adaptive_layers = adaptive_layers
        self.ref_pool = tuple(ref_pool)
        use_sn = "spectral" in norm
        kw = 4
        nf, nf_prev = ndf, input_nc
        for n in range(adaptive_layers):
            setattr(self, f"encoder_{n}", nn.Conv2d(nf_prev, nf, kw, 2, padding=2))
            setattr(self, f"fc_{n}", nn.Linear(self.ref_pool[0] * self.ref_pool[1],
                                               nf_prev * kw * kw))
            setattr(self, f"adaptive_norm_{n}", InstanceNorm(nf, affine=False, eps=1e-5))
            nf_prev, nf = nf, min(nf * 2, 512)
        for n in range(adaptive_layers, n_layers + 1):
            nf = min(nf_prev * 2, 512)
            setattr(self, f"model{n}", _fixed_layer(nf_prev, nf, 2 if n != n_layers else 1,
                                                    norm, use_sn))
            nf_prev = nf
        setattr(self, f"model{n_layers + 1}",
                nn.Sequential(SNConv(nf_prev, 1, kw, 1, use_sn=use_sn)))

    def forward(self, x, ref):
        """x: (B, input_nc, H, W); ref: (B, input_nc, h, w), the reference
        whose encoding generates the first layers' kernels."""
        kw = 4
        h = ref
        res = [x]
        for n in range(self.adaptive_layers):
            h = leaky_relu(getattr(self, f"encoder_{n}")(h))
            b, ch = h.shape[:2]
            feat = adaptive_avg_pool(h, self.ref_pool).reshape(b * ch, -1)
            w = getattr(self, f"fc_{n}")(feat).reshape(b, ch, -1, kw, kw)
            y = batch_conv(res[-1], w, stride=2)
            res.append(leaky_relu(getattr(self, f"adaptive_norm_{n}")(y)))
        for n in range(self.adaptive_layers, self.n_layers + 2):
            res.append(getattr(self, f"model{n}")(res[-1]))
        return res[1:] if self.get_interm_feat else res[-1]


class MultiscaleDiscriminator(nn.Module):
    """num_D discriminators of `subarch` ('n_layers' or 'adaptive').  The
    adaptive ones generate `adaptive_layers` kernels from the reference
    pooled to `ref_pool` = (fine_size / 8 / aspect_ratio, fine_size / 8) at
    every scale (`adaptive_ref_pool`)."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 4,
                 norm: str = "spectralinstance", subarch: str = "n_layers",
                 num_D: int = 1, get_interm_feat: bool = True,
                 adaptive_layers: int = 1, ref_pool=(4, 4)):
        super().__init__()
        if subarch not in SUBARCHS:
            raise ValueError(f"netD_subarch={subarch!r}: one of {SUBARCHS}")
        self.num_D = num_D
        self.adaptive = subarch == "adaptive"
        for i in range(num_D):
            setattr(self, f"discriminator_{i}", AdaptiveDiscriminator(
                input_nc, ndf, n_layers, norm, get_interm_feat, adaptive_layers, ref_pool)
                if self.adaptive else NLayerDiscriminator(
                input_nc, ndf, n_layers, norm, get_interm_feat))

    def forward(self, x, ref: Optional[torch.Tensor] = None) -> List[List[torch.Tensor]]:
        """Returns one list of per-layer activations per scale, finest
        first; the last entry of each is the logit map.  `ref` is the
        adaptive discriminators' reference input, and only theirs."""
        if self.adaptive != (ref is not None):
            raise ValueError("the adaptive discriminator takes a ref, the n_layers one none")
        result = []
        for i in range(self.num_D):
            d = getattr(self, f"discriminator_{i}")
            out = d(x, ref) if self.adaptive else d(x)
            result.append(out if isinstance(out, list) else [out])
            if i != self.num_D - 1:
                x = avg_pool(x, 3, 2, 1, count_include_pad=False)
                if ref is not None:
                    ref = avg_pool(ref, 3, 2, 1, count_include_pad=False)
        return result


def adaptive_ref_pool(fine_size: int, aspect_ratio: float):
    """(sh, sw) the adaptive discriminator pools its encoded reference to
    (JAX AdaptiveDiscriminator: sw = fine_size // 8, sh = int(sw / aspect))."""
    sw = fine_size // 8
    return int(sw / aspect_ratio), sw
