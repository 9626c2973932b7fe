"""Loss assembly for face training (port of fsvid2vid_tpu/losses/collector.py,
reference models/loss_collector.py), as functions of (config, callables,
NCHW tensors).  Frame chunks are single frames; the temporal GAN loss reads
the channel-stacked previous frames.  Loss names follow the reference.

Not ported: the face-region discriminator (`add_face_D`) and the pose-only
warp and mask terms (`is_pose`); they raise.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.losses.gan import (
    feature_matching_loss, gan_loss, l1_loss, masked_l1_loss)
from fsvid2vid_tpu_torch.models.vgg import VGG_LOSS_WEIGHTS

Tensor = torch.Tensor

def check_supported(cfg: Config):
    if cfg.add_face_D:
        raise NotImplementedError("add_face_D (the face-region discriminator) "
                                  "is not ported")
    if cfg.is_pose:
        raise NotImplementedError("the pose losses (body-part warp and mask "
                                  "terms) are not ported")


def _zero(like: Tensor) -> Tensor:
    return torch.zeros((), dtype=torch.float32, device=like.device)


def divide_pred(pred):
    """Split a discriminator output on a fake-then-real batch in two."""
    fake = [[t[:t.shape[0] // 2] for t in p] for p in pred]
    real = [[t[t.shape[0] // 2:] for t in p] for p in pred]
    return fake, real


def discriminate(cfg: Config, apply_D: Callable, tgt_label, fake_image,
                 tgt_image, ref_image, for_discriminator: bool):
    """Run D once on fake and real concatenated on the batch axis (reference
    loss_collector.py:47-68).  Returns [D_real, D_fake] or
    [G_GAN, G_GAN_Feat]."""
    tgt_concat = torch.cat([fake_image, tgt_image], 0)
    if tgt_label is not None:
        tgt_concat = torch.cat([torch.cat([tgt_label, tgt_label], 0), tgt_concat], 1)
    if ref_image is not None:
        if not cfg.concat_ref_for_D:
            raise NotImplementedError("the adaptive discriminator is not ported")
        tgt_concat = torch.cat([torch.cat([ref_image, ref_image], 0), tgt_concat], 1)
    pred_fake, pred_real = divide_pred(apply_D(tgt_concat))
    if for_discriminator:
        return [gan_loss(pred_real, True, cfg.gan_mode, True),
                gan_loss(pred_fake, False, cfg.gan_mode, True)]
    # The reference calls its GAN criterion on the fake with the default
    # for_discriminator=True, so under hinge the generator's loss is the
    # saturating mean(relu(1 - x)), not -mean(x).  Its gradient vanishes for
    # x > 1, which shapes the GAN dynamics; the JAX package reproduces it on
    # purpose and so does the port.
    loss_G = gan_loss(pred_fake, True, cfg.gan_mode, True)
    loss_feat = _zero(fake_image)
    if not cfg.no_ganFeat_loss:
        loss_feat = feature_matching_loss(pred_real, pred_fake, cfg.lambda_feat)
    return [loss_G, loss_feat]


def compute_gan_losses(cfg: Config, applies: Dict[str, Callable], tgt_label,
                       tgt_image, fake_image, ref_label, ref_image,
                       for_discriminator: bool, for_temporal: bool = False):
    """Main (+ zero face) or temporal GAN losses (reference
    loss_collector.py:87-120).  fake_image / tgt_image may be [main, raw]
    pairs (raw may be None); the losses sum over the pair.  Labels are the
    valid labels; face configurations have no foreground mask to append."""
    check_supported(cfg)
    if isinstance(fake_image, list):
        results = [compute_gan_losses(cfg, applies, tgt_label, r, f, ref_label,
                                      ref_image, for_discriminator, for_temporal)
                   for f, r in zip(fake_image, tgt_image) if f is not None]
        return [sum(item[i] for item in results) for i in range(len(results[0]))]
    if for_temporal:
        losses = discriminate(cfg, applies["DT"], None, fake_image, tgt_image,
                              None, for_discriminator)
        if not for_discriminator:
            losses = [l * cfg.lambda_temp for l in losses]
        return losses
    if cfg.concat_fg_mask_for_D:
        raise NotImplementedError("foreground masks for D are not ported")
    losses = discriminate(cfg, applies["D"], tgt_label, fake_image, tgt_image,
                          torch.cat([ref_label, ref_image], 1), for_discriminator)
    z = _zero(fake_image)
    return losses + [z, z]


def vgg_perceptual(vgg_apply: Callable, x: Tensor, y: Tensor) -> Tensor:
    """Weighted L1 over VGG activations; the target's are detached."""
    loss = 0.0
    for w, xf, yf in zip(VGG_LOSS_WEIGHTS, vgg_apply(x), vgg_apply(y)):
        loss = loss + w * (xf.float() - yf.detach().float()).abs().mean()
    return loss


def compute_vgg_losses(cfg: Config, vgg_apply, fake_image, fake_raw_image,
                       tgt_image, fg_mask_union) -> Tensor:
    if cfg.no_vgg_loss or vgg_apply is None:
        return _zero(fake_image)
    loss = vgg_perceptual(vgg_apply, fake_image, tgt_image)
    if fake_raw_image is not None:
        loss = loss + vgg_perceptual(vgg_apply, fake_raw_image,
                                     tgt_image * fg_mask_union)
    return loss * cfg.lambda_vgg


def _flow_loss_single(cfg: Config, flow, warped, tgt_image, flow_gt, conf_gt,
                      fg_mask):
    z = _zero(tgt_image)
    if flow is None or not cfg.is_train:
        return z, z
    loss_flow = z
    if flow_gt is not None and cfg.n_shot == 1:
        mask = conf_gt * fg_mask if fg_mask is not None else conf_gt
        loss_flow = masked_l1_loss(flow.float(), flow_gt, mask)
    return loss_flow, l1_loss(warped.float(), tgt_image.float())


def compute_flow_losses(cfg: Config, flow, warped_image, tgt_image, flow_gt,
                        conf_gt, fg_mask):
    """Flow supervision against the teacher and warp reconstruction
    (reference loss_collector.py:132-154).  flow / warped_image / flow_gt /
    conf_gt: [ref, prev] entries, None where absent.  Returns
    (loss_flow, loss_warp)."""
    check_supported(cfg)
    lf_r, lw_r = _flow_loss_single(cfg, flow[0], warped_image[0], tgt_image,
                                   flow_gt[0], conf_gt[0], fg_mask)
    lf_p, lw_p = _flow_loss_single(cfg, flow[1], warped_image[1], tgt_image,
                                   flow_gt[1], conf_gt[1], fg_mask)
    return (lf_r + lf_p) * cfg.lambda_flow, (lw_r + lw_p) * cfg.lambda_flow


def _mask_loss_single(flow_mask, warped, tgt_image):
    """Occlusion-mask confidence loss (reference loss_collector.py:190-204):
    the mask should be 0 where the warped image already matches the target
    and 1 where it does not."""
    if flow_mask is None:
        return _zero(tgt_image)
    img_diff = (warped.float() - tgt_image.float()).abs().sum(1, keepdim=True)
    conf = (1 - img_diff).clamp(0.0, 1.0)
    m = flow_mask.float()
    return (masked_l1_loss(m, torch.zeros_like(m), conf)
            + masked_l1_loss(m, torch.ones_like(m), 1 - conf))


def compute_mask_losses(cfg: Config, flow_mask, warped_image, tgt_image) -> Tensor:
    check_supported(cfg)
    if not cfg.is_train:
        return _zero(tgt_image)
    loss = (_mask_loss_single(flow_mask[0], warped_image[0], tgt_image)
            + _mask_loss_single(flow_mask[1], warped_image[1], tgt_image))
    return loss * cfg.lambda_mask
