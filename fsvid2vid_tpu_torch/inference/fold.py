"""Inference-time spectral-norm folding (port of
fsvid2vid_tpu/inference/fold.py).

At eval the power-iteration vectors are frozen, so sigma = u^T W v is a
constant per weight: divide each spectrally normalised weight by it once
instead of on every forward.  `serving_module` also lays the weights out
channels-last, as the served forward runs.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from fsvid2vid_tpu_torch.models.layers import _SpectralNormed
from fsvid2vid_tpu_torch.ops.spectral_norm import sigma


@torch.no_grad()
def fold_spectral_norm(model: nn.Module) -> nn.Module:
    """Divide every spectral-norm `weight_orig` of `model` by its sigma, in
    place, and mark the module folded.  Folding twice is a no-op.  Returns
    `model`.  Inference only: the folded weights are not the stored ones."""
    for m in model.modules():
        if isinstance(m, _SpectralNormed) and m.use_sn and not m.folded:
            s = sigma(m.weight_orig, m.weight_u, m.weight_v)
            m.weight_orig.div_(s.to(m.weight_orig.dtype))
            m.folded = True
    return model


def serving_module(model: nn.Module) -> nn.Module:
    """`model` as it serves, in place: at eval, its spectral norms folded
    and its 4-D weights channels-last, so that every convolution of a
    channels-last input runs on NHWC operands with no transpose (and the
    bf16 copies that autocast makes keep the layout).  Returns `model`."""
    return fold_spectral_norm(model.eval()).to(memory_format=torch.channels_last)
