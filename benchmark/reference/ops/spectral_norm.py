# The benchmark's frozen copy of fsvid2vid_tpu_torch/ops/spectral_norm.py, its imports
# pointed at this package: it imports nothing of the port.
"""Spectral normalisation (port of fsvid2vid_tpu/ops/spectral_norm.py).

torch.nn.utils.spectral_norm semantics: the weight matrix is the tensor
reshaped to (out_features, -1); sigma = u^T W v and the normalised weight is
W / sigma.  At eval u and v are the stored vectors.  In train mode every
forward first advances them by power iterations without gradient and writes
them back; sigma is differentiable through W only.  Everything here runs in
f32, outside autocast.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def _l2normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (x.norm() + _EPS)


def sigma(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u^T W v in f32 for a torch-layout weight (out, ...)."""
    with torch.autocast(weight.device.type, enabled=False):
        mat = weight.float().reshape(weight.shape[0], -1)
        return u.float() @ (mat @ v.float())


def spectral_normalize(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                       update: bool, iters: int = 1) -> torch.Tensor:
    """sigma of a torch-layout weight from the buffers u and v.  With
    `update`, `iters` power iterations (v = normalise(W^T u), u =
    normalise(W v)) run first under no_grad and the buffers are overwritten;
    sigma then uses copies of the new vectors, so a later in-place advance
    does not disturb this forward's graph."""
    if not update:
        return sigma(weight, u, v)
    with torch.autocast(weight.device.type, enabled=False):
        mat = weight.float().reshape(weight.shape[0], -1)
        with torch.no_grad():
            nu, nv = u.float(), v.float()
            for _ in range(iters):
                nv = _l2normalize(mat.t() @ nu)
                nu = _l2normalize(mat @ nv)
            u.copy_(nu)
            v.copy_(nv)
        return nu @ (mat @ nv)


def power_iteration(weight: torch.Tensor, u: torch.Tensor, iters: int):
    """Leading singular vectors (u, v) of the weight matrix from start u."""
    mat = weight.float().reshape(weight.shape[0], -1)
    v = _l2normalize(mat.t() @ u)
    for _ in range(iters):
        v = _l2normalize(mat.t() @ u)
        u = _l2normalize(mat @ v)
    return u, v
