"""InceptionV3 pool3 feature extractor for standard FID (port of
fsvid2vid_tpu/eval/inception.py).

The canonical FID statistic (Heusel et al. 2017; pytorch-fid) uses the
2048-d InceptionV3 "pool3" features.  No weights ship with the repository,
so FID defaults to VGG-space features (eval/metrics.py); this module makes
it standard once a user supplies a torchvision-layout `inception_v3` state
dict (torchvision's file, or pytorch-fid's converted FID weights, whose
trunk uses the same `Mixed_5b.branch1x1.conv.weight` keys).

The torchvision feature trunk without its auxiliary head and classifier:
BasicConv2d = bias-free conv + BatchNorm(eps = 1e-3) + relu, eval-mode
batch norm on the file's running statistics.  Module names are
torchvision's, so the file loads with a strict `load_state_dict` of the
trunk's keys (utils/convert.py `load_trunk`).  NCHW inside; the extractor takes
(B, H, W, 3) images in [-1, 1], as the JAX one does (no further input
transform).
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from fsvid2vid_tpu_torch import resolve_device
from fsvid2vid_tpu_torch.ops.image_ops import resize_bilinear
from fsvid2vid_tpu_torch.utils.convert import load_trunk

Pair = Union[int, Tuple[int, int]]


class BasicConv2d(nn.Module):
    """conv(bias=False) + BatchNorm(eps=0.001, eval) + relu."""

    def __init__(self, cin: int, cout: int, kernel: Pair, stride: int = 1,
                 padding: Pair = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3(x):
    """3x3 stride-1 average pool, padding 1 counted (the branch pools)."""
    return F.avg_pool2d(x, 3, 1, 1)


def _max_pool3(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool3(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool3(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg_pool3(x))], 1)


class InceptionV3Pool3(nn.Module):
    """The feature trunk up to the 2048-d global average pool."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x):
        """x: (B, 3, H, W) -> (B, 2048)."""
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool3(x)))
        x = _max_pool3(x)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return x.mean(dim=(-2, -1))


def _resize_bilinear(x: torch.Tensor, size: int = 299) -> torch.Tensor:
    """(B, C, H, W) to size x size as jax.image.resize's "bilinear" does
    (antialiased when it shrinks)."""
    return resize_bilinear(x, (size, size))


def make_inception_extractor(ckpt_path: str, device=None) -> Callable:
    """imgs (B, H, W, 3) in [-1, 1] -> (B, 2048) pool3 features, on `device`
    (CUDA unless the caller names another).  ckpt_path: a torch state dict
    in torchvision's inception_v3 layout."""
    net = load_trunk(InceptionV3Pool3(), ckpt_path).to(resolve_device(device)).eval()

    @torch.no_grad()
    def extract(imgs: torch.Tensor) -> torch.Tensor:
        return net(_resize_bilinear(imgs.float().movedim(-1, -3)))
    return extract
