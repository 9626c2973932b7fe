"""Alternating D / G training step (port of fsvid2vid_tpu/training/step.py;
reference train.py:44-62 with vid2vid_model.forward_generator /
forward_discriminator).

One call processes one frame of the batch's sequences: the discriminator
update on detached generations, the generator update against the updated
discriminator, then the detached advance of the previous-frames buffers.
The batch and the buffers keep the JAX package's channels-last layouts; the
networks and the losses run NCHW.

  batch: tgt_label (B, H, W, Cl), tgt_image (B, H, W, 3),
         ref_labels (B, K, H, W, Cl), ref_images (B, K, H, W, 3), and
         optionally flow_gt / conf_gt = [ref, prev] with (B, H, W, 2 | 1)
         entries or None (the flow teacher's output for this frame)
  prevs: label (B, H, W, Cl (n_frames_G - 1)), real and fake
         (B, H, W, 3 (n_frames_G - 1))

`compute_dtype="bfloat16"` runs the networks' convolutions and matrix
products in bf16 under autocast; parameters, optimizer moments, norm
statistics, spectral sigma, the VGG features and every loss stay f32.

The two steps differ as in the JAX package:
  * `train_step` runs the generator once; its detached outputs feed the D
    update and the G loss is taken on the same graph.  Spectral u / v of G
    and D advance once per step and batch statistics move once; the G
    phase's pass through D advances D's u / v for that pass only.
  * `train_step_faithful` runs the generator twice, as the reference does
    (without gradient for the D update, with gradient for the G update), so
    G's and D's u / v advance twice per step, the G phase seeing the values
    the D phase left.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

import torch

from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.losses import collector as lc
from fsvid2vid_tpu_torch.models.generator import pick_ref
from fsvid2vid_tpu_torch.models.input_process import (
    combine_fg_mask, get_fg_mask, use_valid_labels)
from fsvid2vid_tpu_torch.training.state import ModelBundle, TrainState

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class StepFlags:
    warp_prev: bool = False   # temporal phase (epoch > niter_single)
    has_prev: bool = False    # the previous-frames buffers are filled (t > 0)
    use_pool: bool = False    # D sees replay-pool fakes (cfg.pool_size > 0); the
    # batch then carries pool_fake (B, H, W, 3) and pool_mask (B, 1, 1, 1) bool

    @property
    def temporal_active(self) -> bool:
        return self.warp_prev and self.has_prev


def init_prevs(cfg: Config, batch) -> Dict[str, Tensor]:
    """Zero previous-frames buffers for `batch`."""
    label = batch["tgt_label"]
    b, h, w = label.shape[:3]
    cl = label.shape[-1] if cfg.label_nc == 0 else cfg.label_nc
    n = cfg.n_frames_G - 1
    mk = lambda c: torch.zeros(b, h, w, c, dtype=torch.float32, device=label.device)
    return {"label": mk(cl * n), "real": mk(3 * n), "fake": mk(3 * n)}


def advance_prevs(cfg: Config, prevs, tgt_label_valid, tgt_image, fake_image):
    """Detached ring-buffer advance (reference vid2vid_model.py:169-176)."""
    def roll(buf, new):
        new = new.detach().float()
        c = new.shape[-1]
        if buf.shape[-1] == c:   # n_frames_G == 2: the buffer holds one frame
            return new
        return torch.cat([buf[..., c:], new], -1)
    return {"label": roll(prevs["label"], tgt_label_valid),
            "real": roll(prevs["real"], tgt_image),
            "fake": roll(prevs["fake"], fake_image)}


def _nchw(x):
    return None if x is None else x.movedim(-1, -3)


def _nhwc(x):
    return None if x is None else x.detach().movedim(-3, -1)


def _autocast(device: torch.device, compute_dtype: str):
    if compute_dtype == "bfloat16":
        return torch.autocast(device.type, torch.bfloat16)
    if compute_dtype != "float32":
        raise ValueError(f"compute_dtype {compute_dtype!r}: float32 or bfloat16")
    return contextlib.nullcontext()


def generate_images(cfg: Config, models: ModelBundle, batch, prevs,
                    flags: StepFlags):
    """One frame's generation (reference vid2vid_model.generate_images).
    The generator runs in the mode it is in.  Returns (outputs, masks, refs)
    with NCHW tensors."""
    tgt_label, ref_labels = batch["tgt_label"], batch["ref_labels"]
    ref_images = batch["ref_images"]
    tgt_label_valid = use_valid_labels(cfg, tgt_label)
    ref_labels_valid = use_valid_labels(cfg, ref_labels)
    prev_l = _nchw(prevs["label"]) if flags.has_prev else None
    prev_i = _nchw(prevs["fake"]) if flags.has_prev else None

    out = models.netG(_nchw(tgt_label_valid), _nchw(ref_labels_valid),
                      _nchw(ref_images), prev_l, prev_i, warp_prev=flags.warp_prev)
    ref_idx = out["ref_idx"]
    ref_label = pick_ref(ref_labels, ref_idx)

    fg_mask = _nchw(get_fg_mask(cfg, tgt_label))
    ref_fg_mask = _nchw(get_fg_mask(cfg, ref_label))
    fake_raw = out["img_raw"]
    if fake_raw is not None and cfg.has_fg:
        fake_raw = fake_raw * combine_fg_mask(fg_mask, ref_fg_mask, True)

    outputs = dict(fake_image=out["img_final"], fake_raw=fake_raw,
                   warped=out["img_warp"], flow=out["flow"],
                   flow_mask=out["flow_mask"],
                   tgt_label_valid=_nchw(tgt_label_valid))
    masks = dict(fg=fg_mask, ref_fg=ref_fg_mask)
    refs = dict(label=_nchw(ref_label), image=_nchw(pick_ref(ref_images, ref_idx)))
    return outputs, masks, refs


def _applies(models: ModelBundle, with_vgg: bool):
    applies = {"D": models.netD, "DT": models.netDT, "vgg": None}
    if with_vgg and models.vgg is not None:
        def vgg_apply(x):   # f32 outside autocast, as the JAX step runs it
            with torch.autocast(x.device.type, enabled=False):
                return models.vgg(x.float())
        applies["vgg"] = vgg_apply
    return applies


def _temporal_stacks(batch_n, prevs, fake_image):
    tgt_all = torch.cat([_nchw(prevs["real"]), batch_n["tgt_image"]], 1)
    fake_all = torch.cat([_nchw(prevs["fake"]).to(fake_image.dtype), fake_image], 1)
    return tgt_all, fake_all


def _g_losses(cfg, models, batch_n, prevs, flags, outputs, masks, refs):
    """Generator-side losses of the generated outputs."""
    applies = _applies(models, with_vgg=True)
    tgt_image = batch_n["tgt_image"]
    fake_image, fake_raw = outputs["fake_image"], outputs["fake_raw"]
    zero = torch.zeros((), device=tgt_image.device)
    losses = {}
    if cfg.lambda_temp > 0 and flags.temporal_active:
        tgt_all, fake_all = _temporal_stacks(batch_n, prevs, fake_image)
        losses["GT_GAN"], losses["GT_GAN_Feat"] = lc.compute_gan_losses(
            cfg, applies, None, tgt_all, fake_all, None, None,
            for_discriminator=False, for_temporal=True)
    else:
        losses["GT_GAN"] = losses["GT_GAN_Feat"] = zero

    fg_union = combine_fg_mask(masks["fg"], masks["ref_fg"], cfg.has_fg)
    (losses["G_GAN"], losses["G_GAN_Feat"], losses["Gf_GAN"],
     losses["Gf_GAN_Feat"]) = lc.compute_gan_losses(
        cfg, applies, outputs["tgt_label_valid"], [tgt_image, tgt_image * fg_union],
        [fake_image, fake_raw], refs["label"], refs["image"],
        for_discriminator=False)
    losses["G_VGG"] = lc.compute_vgg_losses(cfg, applies["vgg"], fake_image,
                                            fake_raw, tgt_image, fg_union)
    losses["F_Flow"], losses["F_Warp"] = lc.compute_flow_losses(
        cfg, outputs["flow"], outputs["warped"], tgt_image, batch_n["flow_gt"],
        batch_n["conf_gt"], masks["fg"])
    losses["F_Mask"] = lc.compute_mask_losses(cfg, outputs["flow_mask"],
                                              outputs["warped"], tgt_image)
    return sum(losses.values()), losses


def _d_losses(cfg, models, generated, batch_n, prevs, flags, outputs, masks, refs):
    applies = _applies(models, with_vgg=False)
    tgt_image = batch_n["tgt_image"]
    fake_image, fake_raw = generated["fake_image"], generated["fake_raw"]
    zero = torch.zeros((), device=tgt_image.device)
    losses = {}
    fg_union = combine_fg_mask(masks["fg"], masks["ref_fg"], cfg.has_fg)
    (losses["D_real"], losses["D_fake"], losses["Df_real"],
     losses["Df_fake"]) = lc.compute_gan_losses(
        cfg, applies, outputs["tgt_label_valid"], [tgt_image, tgt_image * fg_union],
        [fake_image, fake_raw], refs["label"], refs["image"],
        for_discriminator=True)
    if cfg.lambda_temp > 0 and flags.temporal_active:
        tgt_all, fake_all = _temporal_stacks(batch_n, prevs, fake_image)
        losses["DT_real"], losses["DT_fake"] = lc.compute_gan_losses(
            cfg, applies, None, tgt_all, fake_all, None, None,
            for_discriminator=True, for_temporal=True)
    else:
        losses["DT_real"] = losses["DT_fake"] = zero
    return sum(losses.values()), losses


def _prepare(cfg, state: TrainState, batch, flags: StepFlags):
    if flags.use_pool and not {"pool_fake", "pool_mask"} <= set(batch):
        raise ValueError("use_pool needs pool_fake and pool_mask in the batch")
    models = state.models
    models.netG.train()
    for d in models.discriminators():
        d.train()
    gt = lambda key: [_nchw(x) for x in batch.get(key, [None, None])]
    batch_n = dict(tgt_image=_nchw(batch["tgt_image"]), flow_gt=gt("flow_gt"),
                   conf_gt=gt("conf_gt"))
    return models, batch_n


def _detached(outputs, batch, flags: StepFlags):
    """The generations D is trained on; with the replay pool, each sample's
    fake image is swapped for a stored one where pool_mask says so (the
    trainer owns the pool, utils/image_pool.py)."""
    det = lambda x: None if x is None else x.detach()
    fake = det(outputs["fake_image"])
    if flags.use_pool:
        fake = torch.where(batch["pool_mask"].to(fake.device),
                           _nchw(batch["pool_fake"]).to(fake), fake)
    return dict(fake_image=fake, fake_raw=det(outputs["fake_raw"]))


@contextlib.contextmanager
def _frozen(modules, restore_buffers: bool):
    """The modules' parameters take no gradient inside; with
    `restore_buffers`, their buffers (spectral u / v) get back the values
    they had on entry."""
    params = [p for m in modules for p in m.parameters() if p.requires_grad]
    saved = ([(b, b.clone()) for m in modules for b in m.buffers()]
             if restore_buffers else [])
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)
        with torch.no_grad():
            for b, value in saved:
                b.copy_(value)


def _update(opt: torch.optim.Optimizer, total: Tensor):
    opt.zero_grad(set_to_none=True)
    total.backward()
    opt.step()


def _finish(cfg, state, batch, prevs, outputs, refs, g, d):
    g_total, g_losses = g
    d_total, d_losses = d
    new_prevs = advance_prevs(cfg, prevs, _nhwc(outputs["tgt_label_valid"]),
                              batch["tgt_image"], _nhwc(outputs["fake_image"]))
    state.step += 1
    losses = {k: v.detach().float() for k, v in {
        **g_losses, **d_losses, "G_total": g_total, "D_total": d_total}.items()}
    each = lambda xs: [_nhwc(x) for x in xs]
    visuals = dict(tgt_label=batch["tgt_label"], tgt_image=batch["tgt_image"],
                   ref_label=_nhwc(refs["label"]), ref_image=_nhwc(refs["image"]),
                   fake_image=_nhwc(outputs["fake_image"]),
                   fake_raw=_nhwc(outputs["fake_raw"]), warped=each(outputs["warped"]),
                   flow=each(outputs["flow"]), flow_mask=each(outputs["flow_mask"]))
    return new_prevs, losses, visuals


def train_step(cfg: Config, state: TrainState, batch, prevs, flags: StepFlags,
               compute_dtype: str = "float32"):
    """D update, G update, previous-frames advance, with one generator
    forward.  Updates `state` in place; returns (new_prevs, losses, visuals)
    with losses a dict of 0-d f32 tensors under the reference's names plus
    G_total and D_total."""
    models, batch_n = _prepare(cfg, state, batch, flags)
    with _autocast(batch_n["tgt_image"].device, compute_dtype):
        outputs, masks, refs = generate_images(cfg, models, batch, prevs, flags)
        d = _d_losses(cfg, models, _detached(outputs, batch, flags), batch_n, prevs,
                      flags, outputs, masks, refs)
    _update(state.opt_D, d[0])
    # the G phase sees the updated D; its pass advances D's u / v for this
    # pass only, and D takes no gradient from it
    with _frozen(models.discriminators(), restore_buffers=True):
        with _autocast(batch_n["tgt_image"].device, compute_dtype):
            g = _g_losses(cfg, models, batch_n, prevs, flags, outputs, masks, refs)
        _update(state.opt_G, g[0])
    return _finish(cfg, state, batch, prevs, outputs, refs, g, d)


def train_step_faithful(cfg: Config, state: TrainState, batch, prevs,
                        flags: StepFlags, compute_dtype: str = "float32"):
    """The reference's alternation with two generator forwards per step (see
    the module docstring).  Same arguments and results as `train_step`."""
    models, batch_n = _prepare(cfg, state, batch, flags)
    device = batch_n["tgt_image"].device
    with _autocast(device, compute_dtype):
        with torch.no_grad():
            outputs_d, masks, refs = generate_images(cfg, models, batch, prevs, flags)
        d = _d_losses(cfg, models, _detached(outputs_d, batch, flags), batch_n, prevs,
                      flags, outputs_d, masks, refs)
    _update(state.opt_D, d[0])
    with _frozen(models.discriminators(), restore_buffers=False):
        with _autocast(device, compute_dtype):
            outputs, masks, refs = generate_images(cfg, models, batch, prevs, flags)
            g = _g_losses(cfg, models, batch_n, prevs, flags, outputs, masks, refs)
        _update(state.opt_G, g[0])
    return _finish(cfg, state, batch, prevs, outputs, refs, g, d)
