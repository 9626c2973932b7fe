"""Models and train state of the reference (the port's
fsvid2vid_tpu_torch/training/state.py, copied without its initialisation:
the benchmark fills every parameter and buffer from the seed).  Two Adam
optimizers with the reference's two-time-scale rule (G lr / 2, D lr * 2,
betas (0, beta2); `no_TTUR`: lr, (beta1, 0.999))."""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch
import torch.nn as nn

from benchmark.reference.config import Config
from benchmark.reference.models.discriminator import (
    MultiscaleDiscriminator, adaptive_ref_pool)
from benchmark.reference.models.face_refiner import check_refine_face, face_refiner_config
from benchmark.reference.models.generator import FewShotGenerator
from benchmark.reference.models.layers import _SpectralNormed
from benchmark.reference.models.vgg import Vgg19Features


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


def build_on_device(make, device) -> nn.Module:
    """`make()` built without storage, then given uninitialised storage on
    `device`: the caller fills every parameter and buffer.  With device
    None, `make()` as it is (under a fake tensor mode, which counts FLOP)."""
    if device is None:
        return make()
    with torch.device("meta"):
        net = make()
    return net.to_empty(device=device)


def build_models(cfg: Config, device) -> ModelBundle:
    """The networks of `cfg` on `device`, uninitialised, in train mode (VGG19
    frozen in eval mode)."""
    check_refine_face(cfg)

    def make(factory):
        net = build_on_device(factory, device)
        for m in net.modules():
            if isinstance(m, _SpectralNormed):
                m.power_iters = cfg.sn_power_iters
        return net.train()

    netG = make(lambda: FewShotGenerator(cfg))
    netGf = (make(lambda: FewShotGenerator(face_refiner_config(cfg), for_face=True))
             if cfg.refine_face else None)
    feat = not cfg.no_ganFeat_loss
    netD = make(lambda: MultiscaleDiscriminator(
        cfg.netD_input_nc, cfg.ndf, cfg.n_layers_D, cfg.norm_D,
        cfg.netD_subarch, cfg.num_D, feat, cfg.adaptive_D_layers,
        adaptive_ref_pool(cfg.fine_size, cfg.aspect_ratio)))
    netDT = netDf = vgg = None
    if cfg.n_frames_G > 1:
        netDT = make(lambda: MultiscaleDiscriminator(
            cfg.output_nc * cfg.tD, cfg.ndf, cfg.n_layers_D, cfg.norm_D,
            "n_layers", 1, feat))
    if cfg.add_face_D:
        netDf = make(lambda: MultiscaleDiscriminator(
            cfg.output_nc * 2, cfg.ndf, cfg.n_layers_D, cfg.norm_D,
            "n_layers", 1, feat))
    if not cfg.no_vgg_loss:
        vgg = build_on_device(Vgg19Features, device).eval().requires_grad_(False)
    return ModelBundle(cfg, netG, netD, netDT, vgg, netDf, netGf)


def lr_for_epoch(cfg: Config, epoch: int) -> float:
    """Base learning rate with the linear decay after `niter` epochs."""
    if epoch <= cfg.niter:
        return cfg.lr
    return cfg.lr * (1 - (epoch - cfg.niter) / (cfg.niter_decay + 1))


def set_epoch_lr(cfg: Config, state: "TrainState", epoch: int) -> "TrainState":
    """Set the epoch's decayed learning rates in both optimizers."""
    g_lr, d_lr = ttur_lrs(cfg, lr_for_epoch(cfg, epoch))
    for opt, lr in ((state.opt_G, g_lr), (state.opt_D, d_lr)):
        for group in opt.param_groups:
            group["lr"] = lr
    return state


def ttur_lrs(cfg: Config, base_lr: float):
    if cfg.no_TTUR:
        return base_lr, base_lr
    return base_lr / 2, base_lr * 2


class TrainState:
    """The models, their two optimizers and the step count."""

    def __init__(self, cfg: Config, models: ModelBundle,
                 params_G: Optional[Iterable[nn.Parameter]] = None):
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
