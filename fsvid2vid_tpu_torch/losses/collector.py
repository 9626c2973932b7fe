"""Loss assembly (port of fsvid2vid_tpu/losses/collector.py, reference
models/loss_collector.py), as functions of (config, callables, NCHW
tensors).  Frame chunks are single frames; the temporal GAN loss reads the
channel-stacked previous frames.  Loss names follow the reference.

Pose configurations add the foreground masks to D's input, the face-region
discriminator on face crops (`add_face_D`), and the body-part warp and mask
terms; they need the raw (not `use_valid_labels`) pose labels, from which
the foreground, part and face masks and the face boxes derive.

The main discriminator D sees the reference concatenated to its input
(`concat_ref_for_D`), or, when it is the adaptive discriminator, as a
second input from which it generates its first kernels.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.losses.gan import (
    feature_matching_loss, gan_loss, l1_loss, masked_l1_loss)
from fsvid2vid_tpu_torch.models.face_refiner import crop_face_region
from fsvid2vid_tpu_torch.models.input_process import (
    get_fg_mask, get_part_mask, smoothed_face_mask)
from fsvid2vid_tpu_torch.models.vgg import VGG_LOSS_WEIGHTS
from fsvid2vid_tpu_torch.ops.warp import flow_warp
from fsvid2vid_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


def _nhwc(x: Tensor) -> Tensor:
    return x.movedim(1, -1)


def _nchw(x: Tensor) -> Tensor:
    return x.movedim(-1, 1)


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
    loss_collector.py:47-68); the reference, where there is one, is
    concatenated on the channels with concat_ref_for_D, else passed to D as
    `apply_D(x, ref)`.  Returns [D_real, D_fake] or [G_GAN, G_GAN_Feat]."""
    tgt_concat = torch.cat([fake_image, tgt_image], 0)
    if tgt_label is not None:
        tgt_concat = torch.cat([torch.cat([tgt_label, tgt_label], 0), tgt_concat], 1)
    if ref_image is None:
        out = apply_D(tgt_concat)
    elif cfg.concat_ref_for_D:
        out = apply_D(torch.cat([torch.cat([ref_image, ref_image], 0), tgt_concat], 1))
    else:
        out = apply_D(tgt_concat, torch.cat([ref_image, ref_image], 0))
    pred_fake, pred_real = divide_pred(out)
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


def discriminate_face(cfg: Config, apply_Df: Callable, vgg_apply, fake_image,
                      tgt_label_raw, tgt_image, ref_label, ref_image,
                      for_discriminator: bool):
    """Face-region GAN losses (reference loss_collector.py:70-85): the face
    boxes of the raw target and reference labels cropped from the images,
    D_f on [reference face, fake or real face], times lambda_face; for G
    also the L1 and, with the VGG loss on, the VGG loss of the face crops.
    Returns [Df_real, Df_fake] or [Gf_GAN, Gf_GAN_Feat].  Span
    fsv.train.face_d, in both the D and the G losses."""
    if not cfg.add_face_D:
        z = _zero(fake_image)
        return [z, z]
    with span("fsv.train.face_d"):
        real_region, fake_region = (_nchw(r) for r in crop_face_region(
            cfg, [_nhwc(tgt_image), _nhwc(fake_image)], _nhwc(tgt_label_raw)))
        ref_region = _nchw(crop_face_region(cfg, _nhwc(ref_image), _nhwc(ref_label)))
        losses = discriminate(cfg, apply_Df, ref_region, fake_region, real_region,
                              None, for_discriminator)
        losses = [l * cfg.lambda_face for l in losses]
        if for_discriminator:
            return losses
        loss_Gf, loss_Gf_feat = losses
        loss_Gf_feat = loss_Gf_feat + l1_loss(fake_region.float(),
                                              real_region.float()) * cfg.lambda_feat
        if not cfg.no_vgg_loss and vgg_apply is not None:
            loss_Gf_feat = loss_Gf_feat + vgg_perceptual(
                vgg_apply, fake_region, real_region) * cfg.lambda_vgg
        return [loss_Gf, loss_Gf_feat]


def compute_gan_losses(cfg: Config, applies: Dict[str, Callable], tgt_label,
                       tgt_image, fake_image, ref_label, ref_image,
                       for_discriminator: bool, for_temporal: bool = False,
                       tgt_label_raw=None):
    """Main and face, or temporal, GAN losses (reference
    loss_collector.py:87-120).  fake_image / tgt_image may be [main, raw]
    pairs (raw may be None); the losses sum over the pair.  tgt_label is the
    valid label, ref_label the reference's raw label; pose configurations
    also need the target's raw label `tgt_label_raw` (the foreground masks
    appended to D's labels, the face boxes).  Returns [main, main, face,
    face] losses, or the two temporal ones."""
    if isinstance(fake_image, list):
        results = [compute_gan_losses(cfg, applies, tgt_label, r, f, ref_label,
                                      ref_image, for_discriminator, for_temporal,
                                      tgt_label_raw)
                   for f, r in zip(fake_image, tgt_image) if f is not None]
        return [sum(item[i] for item in results) for i in range(len(results[0]))]
    if for_temporal:
        losses = discriminate(cfg, applies["DT"], None, fake_image, tgt_image,
                              None, for_discriminator)
        if not for_discriminator:
            losses = [l * cfg.lambda_temp for l in losses]
        return losses
    if (cfg.is_pose or cfg.add_face_D) and tgt_label_raw is None:
        raise ValueError("pose losses need the raw target label (tgt_label_raw)")
    ref_lbl = ref_label
    if cfg.concat_fg_mask_for_D:
        fg = _nchw(get_fg_mask(cfg, _nhwc(tgt_label_raw)))
        ref_fg = _nchw(get_fg_mask(cfg, _nhwc(ref_label)))
        tgt_label = torch.cat([tgt_label, fg], 1)
        ref_lbl = torch.cat([ref_label, ref_fg], 1)
    losses = discriminate(cfg, applies["D"], tgt_label, fake_image, tgt_image,
                          torch.cat([ref_lbl, ref_image], 1), for_discriminator)
    return losses + discriminate_face(
        cfg, applies.get("Df"), applies.get("vgg"), fake_image, tgt_label_raw,
        tgt_image, ref_label, ref_image, for_discriminator)


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
                        conf_gt, fg_mask, tgt_label=None, ref_label=None):
    """Flow supervision against the teacher, warp reconstruction, and for
    pose the warp consistency of the reference's body-part and foreground
    masks (reference loss_collector.py:132-154).  flow / warped_image /
    flow_gt / conf_gt: [ref, prev] entries, None where absent; tgt_label /
    ref_label: the raw labels, needed for pose.  Returns (loss_flow,
    loss_warp, body_mask_diff), the last (B, 1, H, W) for pose, else None."""
    lf_r, lw_r = _flow_loss_single(cfg, flow[0], warped_image[0], tgt_image,
                                   flow_gt[0], conf_gt[0], fg_mask)
    lf_p, lw_p = _flow_loss_single(cfg, flow[1], warped_image[1], tgt_image,
                                   flow_gt[1], conf_gt[1], fg_mask)
    loss_warp = lw_r + lw_p
    body_mask_diff = None
    if cfg.is_train and cfg.is_pose and flow[0] is not None:
        body_mask = _nchw(get_part_mask(tgt_label[:, 2].float()))
        ref_body_mask_warp = flow_warp(_nchw(get_part_mask(ref_label[:, 2].float())),
                                       flow[0])
        loss_warp = loss_warp + l1_loss(ref_body_mask_warp, body_mask)
        if cfg.has_fg:
            fg = _nchw(get_fg_mask(cfg, _nhwc(tgt_label.float())))
            ref_fg_warp = flow_warp(_nchw(get_fg_mask(cfg, _nhwc(ref_label.float()))),
                                    flow[0])
            loss_warp = loss_warp + l1_loss(ref_fg_warp, fg)
        body_mask_diff = (ref_body_mask_warp - body_mask).abs().sum(1, keepdim=True)
    return (lf_r + lf_p) * cfg.lambda_flow, loss_warp * cfg.lambda_flow, body_mask_diff


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


def compute_mask_losses(cfg: Config, flow_mask, warped_image, tgt_image,
                        fake_image=None, tgt_label=None, fg_mask=None,
                        ref_fg_mask=None, body_mask_diff=None) -> Tensor:
    """Occlusion-mask losses (reference loss_collector.py:164-188); for pose
    with warp_ref also: the face comes from the warped reference (and the
    synthesized face equals it, with spade_combine), the regions that the
    reference's foreground or body parts do not cover come from the
    hallucinated image.  tgt_label is the raw label; the masks NCHW."""
    if not cfg.is_train:
        return _zero(tgt_image)
    loss = (_mask_loss_single(flow_mask[0], warped_image[0], tgt_image)
            + _mask_loss_single(flow_mask[1], warped_image[1], tgt_image))
    if cfg.is_pose and cfg.warp_ref and flow_mask[0] is not None:
        mask_ref = flow_mask[0].float()
        zeros, ones = torch.zeros_like(mask_ref), torch.ones_like(mask_ref)
        face_mask = _nchw(smoothed_face_mask(tgt_label[:, 2].float()))
        loss = loss + masked_l1_loss(mask_ref, zeros, face_mask)
        if cfg.spade_combine:
            loss = loss + masked_l1_loss(fake_image.float(),
                                         warped_image[0].detach().float(), face_mask)
        fg_mask_diff = ((ref_fg_mask - fg_mask) > 0).float()
        loss = loss + masked_l1_loss(mask_ref, ones, fg_mask_diff)
        loss = loss + masked_l1_loss(mask_ref, ones, body_mask_diff)
    return loss * cfg.lambda_mask
