"""Precision helpers for serving (port of the two helpers of
fsvid2vid_tpu/parallel/precision.py).

Training and `InferencePipeline` run bf16 under `torch.autocast` with f32
parameters.  A serving export follows the JAX package's recipe instead:
bf16 parameters and bf16 inputs, with the batch-norm statistics and the
spectral-norm state left in f32 (their precision matters, and the vectors
are tiny).  The layers compute their norms in f32 and cast back, so the
program then runs its convolutions and products in bf16 end to end.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
from torch.utils import _pytree as pytree


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast the floating-point tensor leaves of a pytree to `dtype`."""
    def cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x
    return pytree.tree_map(cast, tree)


def bf16_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters and buffers of `model` by name, each tied tensor
    once, with the parameters cast to bf16 and the buffers (batch-norm
    statistics, spectral u / v, counters) left as they are."""
    params = cast_floating(dict(model.named_parameters()), torch.bfloat16)
    return {**{k: v.detach() for k, v in params.items()}, **dict(model.named_buffers())}
