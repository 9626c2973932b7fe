"""PatchGAN discriminators (port of fsvid2vid_tpu/models/discriminator.py,
reference models/networks/discriminator.py), NCHW.

* `NLayerDiscriminator`: stride-2 conv PatchGAN, kernel 4, padding 2,
  spectral + instance norm on the middle layers, returning every layer's
  activation for the feature-matching loss.  Layer 0 and the logit conv are
  plain convs, as in the reference.
* `MultiscaleDiscriminator`: num_D copies on an avg-pool(3, 2, 1,
  count_include_pad=False) pyramid.

Parameter names are the reference's: `discriminator_{i}.model{n}.0.*` for
the first and last layers and `discriminator_{i}.model{n}.0.0.*` (conv) /
`.0.1.*` (norm) for the middle ones.  The adaptive sub-architecture
(per-sample kernels generated from the reference image) is not ported.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from fsvid2vid_tpu_torch.models.layers import SNConv, make_plain_norm
from fsvid2vid_tpu_torch.ops.image_ops import avg_pool


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
            block = [SNConv(nf_prev, nf, kw, stride if n != n_layers else 1,
                            bias=False, use_sn=use_sn)]
            plain = make_plain_norm(norm, nf)
            if plain is not None:
                block.append(plain)
            setattr(self, f"model{n}", nn.Sequential(nn.Sequential(*block),
                                                     nn.LeakyReLU(0.2)))
        setattr(self, f"model{n_layers + 1}",
                nn.Sequential(SNConv(nf, 1, kw, 1, use_sn=False)))

    def forward(self, x):
        res = [x]
        for n in range(self.n_layers + 2):
            res.append(getattr(self, f"model{n}")(res[-1]))
        return res[1:] if self.get_interm_feat else res[-1]


class MultiscaleDiscriminator(nn.Module):
    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 4,
                 norm: str = "spectralinstance", subarch: str = "n_layers",
                 num_D: int = 1, get_interm_feat: bool = True):
        super().__init__()
        if subarch != "n_layers":
            raise NotImplementedError(
                f"netD_subarch={subarch!r} is not ported (the adaptive "
                "discriminator needs adaptive_avg_pool)")
        self.num_D = num_D
        for i in range(num_D):
            setattr(self, f"discriminator_{i}", NLayerDiscriminator(
                input_nc, ndf, n_layers, norm, get_interm_feat))

    def forward(self, x, ref: Optional[torch.Tensor] = None) -> List[List[torch.Tensor]]:
        """Returns one list of per-layer activations per scale, finest
        first; the last entry of each is the logit map.  `ref` is only for
        the adaptive sub-architecture and must be None."""
        if ref is not None:
            raise NotImplementedError("the adaptive discriminator is not ported")
        result = []
        for i in range(self.num_D):
            out = getattr(self, f"discriminator_{i}")(x)
            result.append(out if isinstance(out, list) else [out])
            if i != self.num_D - 1:
                x = avg_pool(x, 3, 2, 1, count_include_pad=False)
        return result
