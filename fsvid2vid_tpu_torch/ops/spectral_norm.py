"""Spectral normalisation at eval (port of fsvid2vid_tpu/ops/spectral_norm.py).

torch.nn.utils.spectral_norm semantics: the weight matrix is the tensor
reshaped to (out_features, -1); at eval sigma = u^T W v from the stored
vectors and the normalised weight is W / sigma.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def _l2normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (x.norm() + _EPS)


def sigma(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u^T W v in f32 for a torch-layout weight (out, ...)."""
    mat = weight.float().reshape(weight.shape[0], -1)
    return u.float() @ (mat @ v.float())


def power_iteration(weight: torch.Tensor, u: torch.Tensor, iters: int):
    """Leading singular vectors (u, v) of the weight matrix from start u."""
    mat = weight.float().reshape(weight.shape[0], -1)
    v = _l2normalize(mat.t() @ u)
    for _ in range(iters):
        v = _l2normalize(mat.t() @ u)
        u = _l2normalize(mat @ v)
    return u, v
