"""Alternating D / G training step (port of fsvid2vid_tpu/training/step.py;
reference train.py:44-62 with vid2vid_model.forward_generator /
forward_discriminator).

One call processes one frame of the batch's sequences: the discriminator
update on detached generations, the generator update against the updated
discriminator, then the detached advance of the previous-frames buffers.
The batch and the buffers keep the JAX package's channels-last layouts; the
networks and the losses run NCHW.  With label_nc > 0 (street) the batch's
labels are class indices, Cl = 1, which the step one-hot encodes into
label_nc channels before anything else sees them (`encode_label`); the
previous-label buffer holds the encoded labels.

  batch: tgt_label (B, H, W, Cl), tgt_image (B, H, W, 3),
         ref_labels (B, K, H, W, Cl), ref_images (B, K, H, W, 3), and
         optionally flow_gt / conf_gt = [ref, prev] with (B, H, W, 2 | 1)
         entries or None (the flow teacher's output for this frame)
         and, with use_kld, vae_eps (B, 256), the VAE's noise
         (`with_vae_noise` draws it on the CPU, so that the card and the
         CPU draw the same z)
  prevs: label (B, H, W, Cl (n_frames_G - 1)), real and fake
         (B, H, W, 3 (n_frames_G - 1))

With refine_face the face generator netGf refines the face region of each
generated frame (models/face_refiner.py `refine_face_region`) before
anything scores it, in both steps, and trains under G's optimiser; its
spectral u / v and batch statistics advance on each of its passes, as the
JAX step's mutated Gf collections.  With use_kld the G losses hold G_KLD,
the VAE's KL divergence times lambda_kld.

`compute_dtype="bfloat16"` runs the networks' convolutions and matrix
products in bf16 under autocast; parameters, optimizer moments, norm
statistics, spectral sigma, the VGG features and every loss stay f32.
With cfg.remat, VGG19 and the generator's up blocks, flow nets and SC
embedders are recomputed in the backward (models/remat.py).

The two steps differ as in the JAX package:
  * `train_step` runs the generator once; its detached outputs feed the D
    update and the G loss is taken on the same graph.  Spectral u / v of G
    and D advance once per step and batch statistics move once; the G
    phase's pass through D advances D's u / v for that pass only.
  * `train_step_faithful` runs the generator twice, as the reference does
    (without gradient for the D update, with gradient for the G update), so
    G's and D's u / v advance twice per step, the G phase seeing the values
    the D phase left.  Both generations take the step's one VAE noise, as
    the JAX step reuses one rng (the reference draws two; ROADMAP.md C).

In a process group (parallel/mesh.py) each rank steps on its rows of the
global batch, and the step stays the global batch's: both updates average
the gradients over the ranks before the optimizer step, batch norm takes
the global statistics, the VAE's KL term (a sum over the batch, not a mean)
is scaled by the world size so that the average is the global sum, each
rank's VAE noise is its rows of the global batch's draw, and the losses
returned are the global batch's.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

import torch

from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.losses import collector as lc
from fsvid2vid_tpu_torch.losses.gan import kld_loss
from fsvid2vid_tpu_torch.models.face_refiner import refine_face_region
from fsvid2vid_tpu_torch.models.generator import Z_DIM, pick_ref, roll_prevs
from fsvid2vid_tpu_torch.models.input_process import (
    combine_fg_mask, encode_label, get_fg_mask, use_valid_labels)
from fsvid2vid_tpu_torch.models.remat import remat
from fsvid2vid_tpu_torch.parallel import mesh
from fsvid2vid_tpu_torch.training.state import ModelBundle, TrainState
from fsvid2vid_tpu_torch.utils.profiling import span

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
    cl = cfg.valid_nc(label.shape[-1] if cfg.label_nc == 0 else cfg.label_nc)
    n = cfg.n_frames_G - 1
    mk = lambda c: torch.zeros(b, h, w, c, dtype=torch.float32, device=label.device)
    return {"label": mk(cl * n), "real": mk(3 * n), "fake": mk(3 * n)}


def advance_prevs(cfg: Config, prevs, tgt_label_valid, tgt_image, fake_image):
    """Detached ring-buffer advance (reference vid2vid_model.py:169-176)."""
    new = {"label": tgt_label_valid, "real": tgt_image, "fake": fake_image}
    return roll_prevs(prevs, **{key: x.detach().float() for key, x in new.items()})


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
    """One frame's generation (reference vid2vid_model.generate_images),
    face refinement included.  The generators run in the mode they are in.
    Returns (outputs, masks, refs) with NCHW tensors."""
    tgt_label, ref_labels = batch["tgt_label"], batch["ref_labels"]
    ref_images = batch["ref_images"]
    tgt_label_valid = use_valid_labels(cfg, tgt_label)
    ref_labels_valid = use_valid_labels(cfg, ref_labels)
    prev_l = _nchw(prevs["label"]) if flags.has_prev else None
    prev_i = _nchw(prevs["fake"]) if flags.has_prev else None

    out = models.netG(_nchw(tgt_label_valid), _nchw(ref_labels_valid),
                      _nchw(ref_images), prev_l, prev_i, warp_prev=flags.warp_prev,
                      vae_eps=batch.get("vae_eps"))
    ref_idx = out["ref_idx"]
    ref_label = pick_ref(ref_labels, ref_idx)
    fake_image = out["img_final"]
    if cfg.refine_face:
        with span("fsv.train.refine_face"):
            fake_image = refine_face_region(
                cfg, models.netGf, tgt_label_valid, fake_image.movedim(1, -1), tgt_label,
                pick_ref(ref_labels_valid, ref_idx), pick_ref(ref_images, ref_idx),
                ref_label).movedim(-1, 1)

    fg_mask = _nchw(get_fg_mask(cfg, tgt_label))
    ref_fg_mask = _nchw(get_fg_mask(cfg, ref_label))
    fake_raw = out["img_raw"]
    if fake_raw is not None and cfg.has_fg:
        fake_raw = fake_raw * combine_fg_mask(fg_mask, ref_fg_mask, True)

    outputs = dict(fake_image=fake_image, fake_raw=fake_raw,
                   warped=out["img_warp"], flow=out["flow"],
                   flow_mask=out["flow_mask"], mu=out["mu"], logvar=out["logvar"],
                   tgt_label_valid=_nchw(tgt_label_valid))
    masks = dict(fg=fg_mask, ref_fg=ref_fg_mask)
    refs = dict(label=_nchw(ref_label), image=_nchw(pick_ref(ref_images, ref_idx)))
    return outputs, masks, refs


def _from_start(net):
    """`net` applied as the JAX step applies a discriminator: every pass of
    one loss computation starts from the buffers (spectral u / v, of the
    adaptive discriminator's fixed layers too) that the computation began
    with, as each JAX apply reads the same aux_D, and the buffers end one
    advance ahead however many passes ran (two when the raw image is scored
    beside the final one, as on street's temporal frames).  The adaptive
    discriminator takes the reference as `ref`."""
    if net is None:
        return None
    start = []

    def apply(x, ref=None):
        with torch.no_grad():
            if start:
                for b, value in start:
                    b.copy_(value)
            else:
                start.extend((b, b.clone()) for b in net.buffers())
        return net(x, ref)
    return apply


def _applies(cfg: Config, models: ModelBundle, with_vgg: bool):
    applies = {"D": _from_start(models.netD), "DT": _from_start(models.netDT),
               "Df": _from_start(models.netDf), "vgg": None}
    if with_vgg and models.vgg is not None:
        def vgg_apply(x):   # f32 outside autocast, as the JAX step runs it
            with torch.autocast(x.device.type, enabled=False):
                return models.vgg(x.float())
        applies["vgg"] = ((lambda x: remat(vgg_apply, x)) if cfg.remat
                          else vgg_apply)
    return applies


def _temporal_stacks(batch_n, prevs, fake_image):
    tgt_all = torch.cat([_nchw(prevs["real"]), batch_n["tgt_image"]], 1)
    fake_all = torch.cat([_nchw(prevs["fake"]).to(fake_image.dtype), fake_image], 1)
    return tgt_all, fake_all


def _g_losses(cfg, models, batch_n, prevs, flags, outputs, masks, refs):
    """Generator-side losses of the generated outputs."""
    applies = _applies(cfg, models, with_vgg=True)
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
        for_discriminator=False, tgt_label_raw=batch_n["tgt_label"])
    losses["G_VGG"] = lc.compute_vgg_losses(cfg, applies["vgg"], fake_image,
                                            fake_raw, tgt_image, fg_union)
    losses["F_Flow"], losses["F_Warp"], body_mask_diff = lc.compute_flow_losses(
        cfg, outputs["flow"], outputs["warped"], tgt_image, batch_n["flow_gt"],
        batch_n["conf_gt"], masks["fg"], batch_n["tgt_label"], refs["label"])
    losses["F_Mask"] = lc.compute_mask_losses(
        cfg, outputs["flow_mask"], outputs["warped"], tgt_image, fake_image,
        batch_n["tgt_label"], masks["fg"], masks["ref_fg"], body_mask_diff)
    if cfg.use_kld:
        # a sum over the batch: the ranks' mean of world x their sums is the global sum
        losses["G_KLD"] = (kld_loss(outputs["mu"], outputs["logvar"])
                           * cfg.lambda_kld * mesh.world())
    return sum(losses.values()), losses


def _d_losses(cfg, models, generated, batch_n, prevs, flags, outputs, masks, refs):
    applies = _applies(cfg, models, with_vgg=False)
    tgt_image = batch_n["tgt_image"]
    fake_image, fake_raw = generated["fake_image"], generated["fake_raw"]
    zero = torch.zeros((), device=tgt_image.device)
    losses = {}
    fg_union = combine_fg_mask(masks["fg"], masks["ref_fg"], cfg.has_fg)
    (losses["D_real"], losses["D_fake"], losses["Df_real"],
     losses["Df_fake"]) = lc.compute_gan_losses(
        cfg, applies, outputs["tgt_label_valid"], [tgt_image, tgt_image * fg_union],
        [fake_image, fake_raw], refs["label"], refs["image"],
        for_discriminator=True, tgt_label_raw=batch_n["tgt_label"])
    if cfg.lambda_temp > 0 and flags.temporal_active:
        tgt_all, fake_all = _temporal_stacks(batch_n, prevs, fake_image)
        losses["DT_real"], losses["DT_fake"] = lc.compute_gan_losses(
            cfg, applies, None, tgt_all, fake_all, None, None,
            for_discriminator=True, for_temporal=True)
    else:
        losses["DT_real"] = losses["DT_fake"] = zero
    return sum(losses.values()), losses


def with_vae_noise(cfg: Config, batch, generator: torch.Generator):
    """`batch` with the VAE's noise vae_eps (B, Z_DIM) when use_kld is on:
    drawn with torch.randn from `generator`, a CPU generator, and moved to
    the batch's device.  In a process group each rank draws the global
    batch's noise and keeps its own rows, so the ranks together take what
    one process would.  Without use_kld the batch is returned as it is."""
    if not cfg.use_kld:
        return batch
    image = batch["tgt_image"]
    eps = torch.randn(image.shape[0] * mesh.world(), Z_DIM, generator=generator)
    return dict(batch, vae_eps=eps[mesh.local_rows(eps.shape[0])].to(image.device))


def _prepare(cfg, state: TrainState, batch, flags: StepFlags):
    """The models in train mode, the batch with its labels encoded
    (reference encode_input) and, with use_kld, its VAE noise, and the NCHW
    views the losses take."""
    if flags.use_pool and not {"pool_fake", "pool_mask"} <= set(batch):
        raise ValueError("use_pool needs pool_fake and pool_mask in the batch")
    batch = dict(batch, tgt_label=encode_label(cfg, batch["tgt_label"]),
                 ref_labels=encode_label(cfg, batch["ref_labels"]))
    if cfg.use_kld and batch.get("vae_eps") is None:
        raise ValueError("use_kld: the batch needs the VAE's noise vae_eps (with_vae_noise)")
    models = state.models
    for net in models.generators() + models.discriminators():
        net.train()
    gt = lambda key: [_nchw(x) for x in batch.get(key, [None, None])]
    batch_n = dict(tgt_image=_nchw(batch["tgt_image"]),
                   tgt_label=_nchw(batch["tgt_label"]), flow_gt=gt("flow_gt"),
                   conf_gt=gt("conf_gt"))
    return models, batch, batch_n


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
    mesh.all_reduce_grads(p for group in opt.param_groups for p in group["params"])
    opt.step()


def _finish(cfg, state, batch, prevs, outputs, refs, g, d):
    g_total, g_losses = g
    d_total, d_losses = d
    new_prevs = advance_prevs(cfg, prevs, _nhwc(outputs["tgt_label_valid"]),
                              batch["tgt_image"], _nhwc(outputs["fake_image"]))
    state.step += 1
    losses = {k: v.detach().float() for k, v in {
        **g_losses, **d_losses, "G_total": g_total, "D_total": d_total}.items()}
    if mesh.is_initialized():   # each rank's mean over its rows -> the global batch's
        keys = list(losses)
        losses = dict(zip(keys, mesh.all_reduce_mean(torch.stack([losses[k] for k in keys]))))
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
    with span("fsv.train.step"):
        models, batch, batch_n = _prepare(cfg, state, batch, flags)
        with _autocast(batch_n["tgt_image"].device, compute_dtype):
            with span("fsv.train.generate"):
                outputs, masks, refs = generate_images(cfg, models, batch, prevs, flags)
            with span("fsv.train.d_losses"):
                d = _d_losses(cfg, models, _detached(outputs, batch, flags), batch_n, prevs,
                              flags, outputs, masks, refs)
        with span("fsv.train.update_D"):
            _update(state.opt_D, d[0])
        # the G phase sees the updated D; its pass advances D's u / v for this
        # pass only, and D takes no gradient from it
        with _frozen(models.discriminators(), restore_buffers=True):
            with _autocast(batch_n["tgt_image"].device, compute_dtype), \
                    span("fsv.train.g_losses"):
                g = _g_losses(cfg, models, batch_n, prevs, flags, outputs, masks, refs)
            with span("fsv.train.update_G"):
                _update(state.opt_G, g[0])
        with span("fsv.train.finish"):
            return _finish(cfg, state, batch, prevs, outputs, refs, g, d)


def train_step_faithful(cfg: Config, state: TrainState, batch, prevs,
                        flags: StepFlags, compute_dtype: str = "float32"):
    """The reference's alternation with two generator forwards per step (see
    the module docstring).  Same arguments and results as `train_step`; its
    step span holds a second fsv.train.generate, the G phase's, before
    fsv.train.g_losses."""
    with span("fsv.train.step"):
        models, batch, batch_n = _prepare(cfg, state, batch, flags)
        device = batch_n["tgt_image"].device
        with _autocast(device, compute_dtype):
            with torch.no_grad(), span("fsv.train.generate"):
                outputs_d, masks, refs = generate_images(cfg, models, batch, prevs, flags)
            with span("fsv.train.d_losses"):
                d = _d_losses(cfg, models, _detached(outputs_d, batch, flags), batch_n,
                              prevs, flags, outputs_d, masks, refs)
        with span("fsv.train.update_D"):
            _update(state.opt_D, d[0])
        with _frozen(models.discriminators(), restore_buffers=False):
            with _autocast(device, compute_dtype):
                with span("fsv.train.generate"):
                    outputs, masks, refs = generate_images(cfg, models, batch, prevs, flags)
                with span("fsv.train.g_losses"):
                    g = _g_losses(cfg, models, batch_n, prevs, flags, outputs, masks, refs)
            with span("fsv.train.update_G"):
                _update(state.opt_G, g[0])
        with span("fsv.train.finish"):
            return _finish(cfg, state, batch, prevs, outputs, refs, g, d)
