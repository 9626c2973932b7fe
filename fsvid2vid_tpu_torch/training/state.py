"""Models and train state (port of fsvid2vid_tpu/training/state.py,
reference models/models.py create_model + base_model.define_networks).

Every network training can need is built up front: the generator (with its
temporal flow branch), with refine_face the face generator netGf (at
n_shot 1 only, models/face_refiner.py `check_refine_face`), the image
discriminator (the adaptive one with netD_subarch 'adaptive', which takes the
reference as a second input and so fewer input channels), the temporal discriminator
when n_frames_G > 1, the face-region discriminator with add_face_D (on
face_size x face_size crops of [reference face, face], 2 x output_nc
channels), and the frozen VGG19 of the perceptual loss.  The train
state owns them and two Adam optimizers with the reference's two-time-scale
rule (G's over netG's and netGf's parameters, as JAX keeps both in
params_G under one opt_G) (G lr / 2, D lr * 2, betas (0, beta2); `no_TTUR`: lr, (beta1, 0.999))
and its linear decay after `niter` epochs.  Parameters, optimizer moments,
norm statistics and spectral u / v stay f32.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch
import torch.nn as nn

from fsvid2vid_tpu_torch import resolve_device
from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.models import (
    build_on_device, init_plain_convs, init_weights)
from fsvid2vid_tpu_torch.models.discriminator import (
    MultiscaleDiscriminator, adaptive_ref_pool)
from fsvid2vid_tpu_torch.models.face_refiner import check_refine_face, face_refiner_config
from fsvid2vid_tpu_torch.models.generator import FewShotGenerator
from fsvid2vid_tpu_torch.models.layers import _SpectralNormed
from fsvid2vid_tpu_torch.models.vgg import Vgg19Features


@dataclasses.dataclass
class ModelBundle:
    cfg: Config
    netG: FewShotGenerator
    netD: Optional[MultiscaleDiscriminator]
    netDT: Optional[MultiscaleDiscriminator]
    vgg: Optional[Vgg19Features]
    netDf: Optional[MultiscaleDiscriminator] = None
    netGf: Optional[FewShotGenerator] = None

    def discriminators(self):
        return [d for d in (self.netD, self.netDT, self.netDf) if d is not None]

    def generators(self):
        return [g for g in (self.netG, self.netGf) if g is not None]


def build_models(cfg: Config, device=None,
                 generator: Optional[torch.Generator] = None) -> ModelBundle:
    """The networks of `cfg` on `device` (CUDA unless the caller names
    another), initialised from `generator` (a CPU torch.Generator; seed
    cfg.seed when None): G and the discriminators with the reference's xavier
    init in train mode, VGG19 frozen with a seeded stand-in for the
    pretrained weights."""
    check_refine_face(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)

    def make(factory):
        net = build_on_device(factory, device)
        for m in net.modules():
            if isinstance(m, _SpectralNormed):
                m.power_iters = cfg.sn_power_iters
        return init_weights(net, generator, cfg.init_variance).train()

    netG = make(lambda: FewShotGenerator(cfg))
    netGf = (make(lambda: FewShotGenerator(face_refiner_config(cfg), for_face=True))
             if cfg.refine_face else None)
    netD = netDT = netDf = vgg = None
    if cfg.is_train or cfg.finetune:
        feat = not cfg.no_ganFeat_loss
        netD = make(lambda: MultiscaleDiscriminator(
            cfg.netD_input_nc, cfg.ndf, cfg.n_layers_D, cfg.norm_D,
            cfg.netD_subarch, cfg.num_D, feat, cfg.adaptive_D_layers,
            adaptive_ref_pool(cfg.fine_size, cfg.aspect_ratio)))
        if cfg.n_frames_G > 1:
            # temporal D over output_nc * tD channel-stacked frames
            netDT = make(lambda: MultiscaleDiscriminator(
                cfg.output_nc * cfg.tD, cfg.ndf, cfg.n_layers_D, cfg.norm_D,
                "n_layers", 1, feat))
        if cfg.add_face_D:
            netDf = make(lambda: MultiscaleDiscriminator(
                cfg.output_nc * 2, cfg.ndf, cfg.n_layers_D, cfg.norm_D,
                "n_layers", 1, feat))
        if not cfg.no_vgg_loss:
            vgg = init_plain_convs(build_on_device(Vgg19Features, device), generator)
            vgg.eval().requires_grad_(False)
    return ModelBundle(cfg, netG, netD, netDT, vgg, netDf, netGf)


def lr_for_epoch(cfg: Config, epoch: int) -> float:
    """Base learning rate with the linear decay after `niter` epochs."""
    if epoch <= cfg.niter:
        return cfg.lr
    return cfg.lr * (1 - (epoch - cfg.niter) / (cfg.niter_decay + 1))


def ttur_lrs(cfg: Config, base_lr: float):
    if cfg.no_TTUR:
        return base_lr, base_lr
    return base_lr / 2, base_lr * 2


class TrainState:
    """The models, their two optimizers and the step count.  `params_G`
    names the generator parameters opt_G trains (all of netG's and netGf's
    by default; test-time finetune passes its subset)."""

    def __init__(self, cfg: Config, models: ModelBundle,
                 params_G: Optional[Iterable[nn.Parameter]] = None):
        if models.netD is None:
            raise ValueError("TrainState needs the discriminators: build the "
                             "models with is_train or finetune set")
        self.cfg = cfg
        self.models = models
        betas = (cfg.beta1, 0.999) if cfg.no_TTUR else (0.0, cfg.beta2)
        g_lr, d_lr = ttur_lrs(cfg, cfg.lr)
        params_D = [p for d in models.discriminators() for p in d.parameters()]
        if params_G is None:
            params_G = [p for g in models.generators() for p in g.parameters()]
        self.opt_G = torch.optim.Adam(params_G, lr=g_lr, betas=betas)
        self.opt_D = torch.optim.Adam(params_D, lr=d_lr, betas=betas)
        self.step = 0


def set_epoch_lr(cfg: Config, state: TrainState, epoch: int) -> TrainState:
    """Set the epoch's decayed learning rates in both optimizers."""
    g_lr, d_lr = ttur_lrs(cfg, lr_for_epoch(cfg, epoch))
    for opt, lr in ((state.opt_G, g_lr), (state.opt_D, d_lr)):
        for group in opt.param_groups:
            group["lr"] = lr
    return state
