# The benchmark's frozen copy of fsvid2vid_tpu_torch/inference/fold.py, its imports
# pointed at this package: it imports nothing of the port.
"""Inference-time spectral-norm folding (port of
fsvid2vid_tpu/inference/fold.py).

At eval the power-iteration vectors are frozen, so sigma = u^T W v is a
constant per weight: divide each spectrally normalised weight by it once
instead of on every forward.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from benchmark.reference.models.layers import _SpectralNormed
from benchmark.reference.ops.spectral_norm import sigma


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
