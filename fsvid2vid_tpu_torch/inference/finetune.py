"""Test-time finetune (port of fsvid2vid_tpu/inference/finetune.py;
reference Vid2VidModel.finetune, vid2vid_model.py:207-237): before an
unseen subject is synthesised, a name-filtered subset of the generator
({fc*, conv_img, up*}: the substring filter of get_train_params,
base_model.py:149-165) and every discriminator take `finetune_iters` (100)
single-frame D+G steps on randomly rolled and flipped copies of the
references.

The steps are the port's `train_step` (training/step.py) with cfg.finetune
set and no previous frames, under fresh Adam optimisers with TrainState's
two-time-scale rates: G's over the filtered parameters only (the JAX
version's masked optimiser zeroes the other updates), D's over all
discriminators.  With refine_face the face generator netGf is filtered by
the same names (JAX's mask walks all of params_G, 'Gf' included; `fc`
also matches the VAE's fc_mu_ref, fc_var_ref and fc).  The other generator
parameters take no gradient during the loop, so they leave it bitwise as
they entered; buffers (spectral u / v,
batch-norm statistics) advance as in any train step.  At K > 1 each step's
target is one of the K references and the generator's attention runs its
train-mode path (ops/attention_kernel.py `chunked_ref_attention`); every input
of the attention comes from parameters outside the mask, so it keeps no
activations for the backward.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.training.state import ModelBundle, TrainState
from fsvid2vid_tpu_torch.training.step import (
    StepFlags, init_prevs, train_step, with_vae_noise)

FINETUNE_NAMES = ("fc", "conv_img", "up")   # vid2vid_model.py:208


def finetune_mask(netG: torch.nn.Module) -> Dict[str, bool]:
    """Parameter name -> whether finetune trains it: any of FINETUNE_NAMES
    is a substring of the name (JAX `finetune_mask` over flax paths)."""
    return {name: any(n in name for n in FINETUNE_NAMES)
            for name, _ in netG.named_parameters()}


def random_roll_np(arrays, rng: np.random.RandomState) -> List[np.ndarray]:
    """Reference random_roll (util/util.py:157-168): one circular shift by
    up to h // 16 and w // 16 in either direction and one random horizontal
    flip, applied to every (B, H, W, C) array.  Draws from `rng` in the JAX
    function's order, so one seed gives the same rolls."""
    h, w = arrays[0].shape[1:3]
    ny = rng.choice([rng.randint(max(h // 16, 1)),
                     h - rng.randint(max(h // 16, 1))])
    nx = rng.choice([rng.randint(max(w // 16, 1)),
                     w - rng.randint(max(w // 16, 1))])
    flip = rng.rand() > 0.5

    def roll(a):
        a = np.roll(np.asarray(a), (int(ny), int(nx)), axis=(1, 2))
        return np.ascontiguousarray(a[:, :, ::-1] if flip else a)
    return [roll(a) for a in arrays]


def finetune(cfg: Config, models: ModelBundle, ref_labels, ref_images,
             seed: int = 0) -> Tuple[TrainState, List[Dict[str, torch.Tensor]]]:
    """Adapt `models` in place to the references (B, K, H, W, C), numpy on
    the host: labels as the dataset gives them (class indices for street),
    images in [-1, 1].  The models must hold the discriminators
    (build_models with cfg.finetune).  Returns the finetune's TrainState
    and each step's losses (0-d tensors on the models' device)."""
    ft_cfg = cfg.replace(finetune=True)
    trained, frozen = [], []
    for net in models.generators():
        mask = finetune_mask(net)
        for n, p in net.named_parameters():
            if mask[n]:
                trained.append(p)
            elif p.requires_grad:
                frozen.append(p)
    state = TrainState(ft_cfg, models, params_G=trained)
    device = next(models.netG.parameters()).device
    on = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    ref_labels = np.asarray(ref_labels, np.float32)
    ref_images = np.asarray(ref_images, np.float32)
    refs = dict(ref_labels=on(ref_labels), ref_images=on(ref_images),
                flow_gt=[None, None], conf_gt=[None, None])
    flags = StepFlags(warp_prev=False, has_prev=False)
    rng = np.random.RandomState(seed)
    vae_gen = torch.Generator().manual_seed(seed)   # the VAE's noise (use_kld)
    history = []
    for p in frozen:
        p.requires_grad_(False)
    try:
        for _ in range(cfg.finetune_iters):
            idx = rng.randint(ref_labels.shape[1])
            tgt_label, tgt_image = random_roll_np(
                [ref_labels[:, idx], ref_images[:, idx]], rng)
            batch = dict(refs, tgt_label=on(tgt_label), tgt_image=on(tgt_image))
            batch = with_vae_noise(ft_cfg, batch, vae_gen)
            _, losses, _ = train_step(ft_cfg, state, batch, init_prevs(ft_cfg, batch),
                                      flags, compute_dtype=cfg.compute_dtype)
            history.append(losses)
    finally:
        for p in frozen:
            p.requires_grad_(True)
    return state, history
