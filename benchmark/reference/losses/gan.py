# The benchmark's frozen copy of fsvid2vid_tpu_torch/losses/gan.py, its imports
# pointed at this package: it imports nothing of the port.
"""GAN objectives (port of fsvid2vid_tpu/losses/gan.py, reference
models/networks/loss.py:17-142).

They work on multiscale-discriminator outputs: a list (one per scale) of
lists of per-layer activations whose last entry is the logit map.  Every
loss is computed in f32.
"""
from __future__ import annotations

from typing import List, Union

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _loss_single(logits: Tensor, target_is_real: bool, mode: str,
                 for_discriminator: bool) -> Tensor:
    x = logits.float()
    if mode == "hinge":
        if for_discriminator:
            if target_is_real:
                return -torch.clamp(x - 1, max=0.0).mean()
            return -torch.clamp(-x - 1, max=0.0).mean()
        if not target_is_real:
            raise ValueError("the generator's hinge loss aims for real")
        return -x.mean()
    if mode == "ls":
        return ((x - (1.0 if target_is_real else 0.0)) ** 2).mean()
    if mode == "original":
        target = torch.full_like(x, 1.0 if target_is_real else 0.0)
        return F.binary_cross_entropy_with_logits(x, target)
    if mode == "w":
        return -x.mean() if target_is_real else x.mean()
    raise ValueError(f"unknown gan mode {mode}")


def gan_loss(pred: Union[Tensor, List], target_is_real: bool, mode: str = "hinge",
             for_discriminator: bool = True) -> Tensor:
    """Mean loss over scales; an inner list contributes its last (logit)
    entry (reference loss.py:92-104)."""
    if isinstance(pred, (list, tuple)):
        losses = [_loss_single(p[-1] if isinstance(p, (list, tuple)) else p,
                               target_is_real, mode, for_discriminator)
                  for p in pred]
        return sum(losses) / len(losses)
    return _loss_single(pred, target_is_real, mode, for_discriminator)


def feature_matching_loss(pred_real, pred_fake, lambda_feat: float) -> Tensor:
    """L1 between the discriminator's activations on fake and on (detached)
    real at every layer but the logits, averaged over scales."""
    num_D = len(pred_fake)
    loss = 0.0
    for i in range(num_D):
        for j in range(len(pred_fake[i]) - 1):
            real = pred_real[i][j].detach().float()
            loss = loss + (pred_fake[i][j].float() - real).abs().mean() / num_D
    return loss * lambda_feat


def masked_l1_loss(x: Tensor, target: Tensor, mask) -> Tensor:
    """mean(|x m - t m|): the mask multiplies both operands."""
    return (x * mask - target * mask).abs().mean()


def l1_loss(x: Tensor, target: Tensor) -> Tensor:
    return (x - target).abs().mean()


def kld_loss(mu: Tensor, logvar: Tensor) -> Tensor:
    """-0.5 sum(1 + logvar - mu^2 - exp(logvar)), the VAE's KL divergence
    from the unit normal (reference loss.py:140-142), in f32."""
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar))
