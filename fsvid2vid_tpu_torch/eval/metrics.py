"""Quality metrics: PSNR, SSIM, LPIPS, FID (port of
fsvid2vid_tpu/eval/metrics.py).

Images enter channel-last, (B, H, W, 3) in the generator's [-1, 1] range,
as in the JAX package; the networks run NCHW inside.

LPIPS follows the official lpips-vgg recipe (Zhang et al. 2018): VGG16
taps after relu1_2 / relu2_2 / relu3_3 / relu4_3 / relu5_3, unit
normalisation over channels, learned non-negative 1x1 weights, spatial
mean, sum over the taps, with the official input shift and scale.  Without
the backbone and calibration files it runs on a seeded random backbone with
uniform weights and says so (`calibrated=False`): its values then compare
only with themselves.

FID is the Frechet distance between Gaussian fits of two feature sets.
The standard extractor is InceptionV3 pool3 (eval/inception.py); without
its file the VGG16 relu4_3 tap, averaged over the image, stands in (the
eval CLI names the feature space it used).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fsvid2vid_tpu_torch import resolve_device
from fsvid2vid_tpu_torch.utils.convert import load_torch_state_dict, load_trunk


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.float().movedim(-1, -3)


# ---------------------------------------------------------------------------
# pixel metrics
# ---------------------------------------------------------------------------

def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """PSNR in dB per image of (..., H, W, C) batches, [-1, 1] by default."""
    mse = ((a.float() - b.float()) ** 2).mean(dim=(-3, -2, -1))
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp(min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """Mean SSIM per image of (B, H, W, C) batches (Wang et al. 2004: an
    11 x 11 Gaussian window of sigma 1.5, no padding, K1 = 0.01, K2 = 0.03)."""
    a, b = _nchw(a), _nchw(b)
    c = a.shape[1]
    win = torch.tensor(_gaussian_kernel(), dtype=torch.float32, device=a.device)
    kernel = win.expand(c, 1, *win.shape)        # depthwise

    def filt(x):
        return F.conv2d(x, kernel, groups=c)

    mu_a, mu_b = filt(a), filt(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = filt(a * a) - mu_aa
    s_bb = filt(b * b) - mu_bb
    s_ab = filt(a * b) - mu_ab
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    ssim_map = ((2 * mu_ab + c1) * (2 * s_ab + c2) /
                ((mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)))
    return ssim_map.mean(dim=(-3, -2, -1))


# ---------------------------------------------------------------------------
# LPIPS (vgg16 backbone)
# ---------------------------------------------------------------------------

# torchvision vgg16.features: position == torchvision layer index
_C, _R, _P = "conv", "relu", "pool"
VGG16_LAYERS = [
    (_C, 64), _R, (_C, 64), _R, _P,
    (_C, 128), _R, (_C, 128), _R, _P,
    (_C, 256), _R, (_C, 256), _R, (_C, 256), _R, _P,
    (_C, 512), _R, (_C, 512), _R, (_C, 512), _R, _P,
    (_C, 512), _R, (_C, 512), _R, (_C, 512), _R, _P,
]
# taps after the relu at these indices: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
LPIPS_TAPS = (3, 8, 15, 22, 29)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)

# the official lpips input normalisation (its scaling layer's shift / scale)
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


class Vgg16Features(nn.Module):
    """vgg16.features up to the last tap, under torchvision's names
    (`features.N.weight`), returning the activations at `taps`."""

    def __init__(self, taps: Sequence[int] = LPIPS_TAPS):
        super().__init__()
        self.taps = tuple(taps)
        layers, cin = [], 3
        for layer in VGG16_LAYERS[:max(self.taps) + 1]:
            if layer == _R:
                layers.append(nn.ReLU())
            elif layer == _P:
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers.append(nn.Conv2d(cin, layer[1], 3, padding=1))
                cin = layer[1]
        self.features = nn.Sequential(*layers)

    def forward(self, x) -> List[torch.Tensor]:
        results = []
        for idx, layer in enumerate(self.features):
            x = layer(x)
            if idx in self.taps:
                results.append(x)
        return results


class LpipsModel(nn.Module):
    """LPIPS distance.  `lin_weights[i]`: the (C_i,) non-negative weights
    of the official 1x1 convs; uniform 1 / C_i when uncalibrated."""

    def __init__(self, net: Vgg16Features, lin_weights: Sequence[torch.Tensor],
                 calibrated: bool):
        super().__init__()
        self.net = net
        for i, w in enumerate(lin_weights):
            self.register_buffer(f"lin{i}", torch.as_tensor(w, dtype=torch.float32))
        self.calibrated = calibrated
        self.register_buffer("shift", torch.tensor(_LPIPS_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_LPIPS_SCALE).view(1, 3, 1, 1))

    def features(self, imgs: torch.Tensor) -> List[torch.Tensor]:
        """The backbone's taps of (B, H, W, 3) images in [-1, 1], NCHW."""
        return self.net((_nchw(imgs) - self.shift) / self.scale)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b: (B, H, W, 3) in [-1, 1].  Returns (B,) distances."""
        total = 0.0
        for i, (xa, xb) in enumerate(zip(self.features(a), self.features(b))):
            na = xa * torch.rsqrt((xa * xa).sum(1, keepdim=True) + 1e-10)
            nb = xb * torch.rsqrt((xb * xb).sum(1, keepdim=True) + 1e-10)
            d = (na - nb) ** 2
            w = getattr(self, f"lin{i}")
            total = total + (d * w[:, None, None]).sum(1).mean(dim=(-2, -1))
        return total


@torch.no_grad()
def _seeded_convs(net: nn.Module, seed: int) -> nn.Module:
    """Seeded stand-in for pretrained weights: conv weights ~ N(0, 1 /
    fan_in) (the variance of flax's default init, which the JAX package's
    stand-in uses; not its draws), zero biases.  Drawn on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * math.prod(m.kernel_size)
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
    return net


def make_lpips(vgg16_ckpt: Optional[str] = None, lpips_ckpt: Optional[str] = None,
               rng_seed: int = 0, device=None) -> LpipsModel:
    """LPIPS on `device` (CUDA unless the caller names another).  vgg16_ckpt:
    a torchvision vgg16 state dict; lpips_ckpt: the official lpips vgg.pth
    (lin0..lin4.model.1.weight).  Either may be None: the uncalibrated
    stand-in, flagged calibrated=False."""
    device = resolve_device(device)
    net = Vgg16Features()
    calibrated = True
    if vgg16_ckpt:
        load_trunk(net, vgg16_ckpt)
    else:
        _seeded_convs(net, rng_seed)
        calibrated = False
    if lpips_ckpt:
        lin = import_lpips_lin(lpips_ckpt)
    else:
        lin = [torch.full((c,), 1.0 / c) for c in LPIPS_CHANNELS]
        calibrated = False
    return LpipsModel(net, lin, calibrated).to(device).eval()


def import_lpips_lin(ckpt_path: str) -> List[torch.Tensor]:
    """The official lpips vgg.pth: linK.model.1.weight of shape (1, C, 1, 1),
    clipped at 0 as the official model does."""
    sd = load_torch_state_dict(ckpt_path)
    return [sd[f"lin{k}.model.1.weight"].detach().float().reshape(-1).clamp(min=0.0)
            for k in range(5)]


# ---------------------------------------------------------------------------
# FID
# ---------------------------------------------------------------------------

def feature_stats(feats: np.ndarray):
    """Gaussian fit of (N, D) features."""
    mu = feats.mean(0)
    cov = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(cov)


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(C1 + C2 - 2 (C1 C2)^(1/2)), the trace of the
    square root as the sum of the square roots of the eigenvalues of the
    symmetric C1^(1/2) C2 C1^(1/2)."""
    diff = mu1 - mu2
    vals1, vecs1 = np.linalg.eigh(cov1 + eps * np.eye(cov1.shape[0]))
    sq1 = (vecs1 * np.sqrt(np.maximum(vals1, 0))) @ vecs1.T
    s = sq1 @ (cov2 + eps * np.eye(cov2.shape[0])) @ sq1
    svals = np.linalg.eigvalsh((s + s.T) / 2)
    tr_sqrt = np.sqrt(np.maximum(svals, 0)).sum()
    # the eps regularisers can push an exact-zero distance a hair negative
    return float(max(0.0, diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * tr_sqrt))


def fid_from_features(real: np.ndarray, fake: np.ndarray) -> float:
    mu_r, c_r = feature_stats(real)
    mu_f, c_f = feature_stats(fake)
    return frechet_distance(mu_r, c_r, mu_f, c_f)


def make_vgg_fid_extractor(lpips_model: LpipsModel, tap_index: int = 3) -> Callable:
    """FID features from the LPIPS backbone's relu4_3 tap, averaged over the
    image: (B, H, W, 3) -> (B, 512).  Not Inception FID: its values compare
    only within this feature space (the eval CLI reports it as such)."""

    @torch.no_grad()
    def extract(imgs: torch.Tensor) -> torch.Tensor:
        return lpips_model.features(imgs)[tap_index].mean(dim=(-2, -1))
    return extract
