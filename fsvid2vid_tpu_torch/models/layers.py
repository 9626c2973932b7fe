"""Core layers (port of fsvid2vid_tpu/models/layers.py) on (B, C, H, W)
maps, in whichever memory layout they come: NCHW, or channels-last in the
served forward (inference/fold.py `serving_module` lays the weights out
channels-last, inference/pipeline.py hands the inputs as channels-last
views), where every convolution then runs on NHWC operands and the norms'
elementwise work keeps the layout.  SPADE's per-sample 1 x 1 convolutions
take batch_conv's batched-product route there (ops/batch_conv.py).

Parameter and buffer names are the reference's torch names, so the modules
load the reference's state dicts directly:

  spectral-norm conv / linear  weight_orig, weight_u, weight_v (+ bias)
  plain conv / linear          weight (+ bias)
  batch norm                   weight, bias, running_mean, running_var,
                               num_batches_tracked

Only the plain layout is ported: the JAX package's space-to-depth branches
(ops/spd.py) are TPU lane packing with identical math.

Train and eval follow `module.training`, as in torch.  At eval the norms use
their running statistics and spectral norm the stored u / v.  In train mode
batch norm uses the batch's statistics and moves the running ones, and every
forward of a spectral-norm layer advances its u / v (ops/spectral_norm.py).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from fsvid2vid_tpu_torch.ops.batch_conv import batch_conv
from fsvid2vid_tpu_torch.ops.image_ops import avg_pool, leaky_relu, resize_nearest
from fsvid2vid_tpu_torch.ops.spectral_norm import spectral_normalize
from fsvid2vid_tpu_torch.parallel import mesh


class _SpectralNormed(nn.Module):
    """Holds `weight_orig` / `weight_u` / `weight_v` (use_sn) or `weight`.

    `folded` is set by inference.fold.fold_spectral_norm once weight_orig has
    been divided by its sigma; the eval forward then skips the sigma matvec,
    and a train-mode forward raises: folded weights are not the stored ones
    and must never be trained.  `power_iters` is the number of power
    iterations per train-mode forward (cfg.sn_power_iters)."""

    def _init_weight(self, shape, use_sn: bool):
        self.use_sn = use_sn
        self.folded = False
        self.power_iters = 1
        if use_sn:
            self.weight_orig = nn.Parameter(torch.empty(shape))
            self.register_buffer("weight_u", torch.empty(shape[0]))
            n_in = 1
            for s in shape[1:]:
                n_in *= s
            self.register_buffer("weight_v", torch.empty(n_in))
        else:
            self.weight = nn.Parameter(torch.empty(shape))

    def effective_weight(self) -> torch.Tensor:
        if not self.use_sn:
            return self.weight
        if self.folded:
            if self.training:
                raise RuntimeError(
                    "train-mode forward of a layer whose spectral norm was "
                    "folded into its weight: folded weights serve inference "
                    "only; reload the unfolded state to train")
            return self.weight_orig
        s = spectral_normalize(self.weight_orig, self.weight_u, self.weight_v,
                               update=self.training, iters=self.power_iters)
        return self.weight_orig / s.to(self.weight_orig.dtype)


class SNConv(_SpectralNormed):
    """Conv2d with optional spectral normalisation; padding k // 2."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, bias: bool = True, use_sn: bool = True):
        super().__init__()
        self._init_weight((cout, cin, kernel_size, kernel_size), use_sn)
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride = stride
        self.padding = kernel_size // 2

    def forward(self, x):
        return F.conv2d(x, self.effective_weight(), self.bias,
                        stride=self.stride, padding=self.padding)


class SNLinear(_SpectralNormed):
    """Linear with optional spectral normalisation (JAX SNDense)."""

    def __init__(self, din: int, dout: int, bias: bool = True,
                 use_sn: bool = True):
        super().__init__()
        self._init_weight((dout, din), use_sn)
        self.bias = nn.Parameter(torch.empty(dout)) if bias else None

    def forward(self, x):
        return F.linear(x, self.effective_weight(), self.bias)


class SyncBatchNorm(nn.Module):
    """Batch norm in f32, cast back to the input dtype.  At eval:
    (x - running_mean) * rsqrt(running_var + eps), then the affine map.  In
    train mode the statistics are the batch's over (B, H, W) (biased
    variance), and the running ones move with momentum 0.1 towards the batch
    mean and the unbiased variance.

    In a process group of more than one rank (parallel/mesh.py) the batch is
    the global one, as under JAX's GSPMD: each rank sums its count, x - m
    and (x - m)^2 per channel, with m the running mean (the same on every
    rank, so the sums keep their precision), and one differentiable
    all-reduce adds them over the ranks, so that the gradient through the
    statistics reaches every rank's input.  The running variance's unbiased
    factor takes the global count.  torch.nn.SyncBatchNorm is not used: it
    needs CUDA, and the CPU tests run their ranks on gloo."""

    eps = 1e-5
    momentum = 0.1

    def __init__(self, features: int, affine: bool = True):
        super().__init__()
        if affine:
            self.weight = nn.Parameter(torch.empty(features))
            self.bias = nn.Parameter(torch.empty(features))
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean", torch.empty(features))
        self.register_buffer("running_var", torch.empty(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x):
        if self.training:
            x32 = x.float()
            n = x.shape[0] * x.shape[2] * x.shape[3]
            if mesh.world() > 1:
                mean, var, unbiased = self._global_stats(x32, n)
            else:
                var, mean = torch.var_mean(x32, (0, 2, 3), unbiased=False)
                unbiased = n / max(n - 1, 1)
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var * unbiased, self.momentum)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        scale = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            scale = scale * self.weight.float()
        shift = -mean * scale
        if self.bias is not None:
            shift = shift + self.bias.float()
        y = torch.addcmul(shift[:, None, None], x.float(), scale[:, None, None])
        return y.to(x.dtype)

    def _global_stats(self, x32, n: int):
        """Mean and biased variance of the global batch, and the unbiased
        variance's factor N / (N - 1) for its count N."""
        m = self.running_mean.detach().float()[:, None, None]
        d = x32 - m
        sums = mesh.all_reduce_sum(torch.cat([
            d.sum((0, 2, 3)), (d * d).sum((0, 2, 3)), d.new_full((1,), float(n))]))
        c = self.running_mean.shape[0]
        n_all = sums[-1]
        shift = sums[:c] / n_all
        var = (sums[c:2 * c] / n_all - shift * shift).clamp_min(0.0)
        return m[:, 0, 0] + shift, var, (n_all / (n_all - 1).clamp_min(1.0)).detach()


class InstanceNorm(nn.Module):
    """InstanceNorm2d with the reference's eps = 0.1 unless told otherwise
    (the adaptive discriminator's takes torch's 1e-5)."""

    def __init__(self, features: int, affine: bool = True, eps: float = 0.1):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.empty(features))
            self.bias = nn.Parameter(torch.empty(features))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean((2, 3), keepdim=True)
        var = x32.var((2, 3), keepdim=True, unbiased=False)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def make_plain_norm(norm: str, features: int) -> Optional[nn.Module]:
    """'instance' -> InstanceNorm, '*batch*' -> SyncBatchNorm, else None."""
    if "instance" in norm:
        return InstanceNorm(features, affine=True)
    if "batch" in norm:
        return SyncBatchNorm(features, affine=True)
    return None


class Spade(nn.Module):
    """Param-free norm, then per-map gamma / beta from conv(map).

    Map i's convs are `mlp_gamma{s}` / `mlp_beta{s}` (s = '' for map 0, else
    i + 1).  With `params_free`, map 0's convs are generated per sample and
    passed as `weights` = (gamma (B, C, Cm, k, k), beta (B, C, Cm, k, k)),
    without bias, as the reference does.  Each map's gamma and beta convs run
    as one conv over concatenated output channels."""

    def __init__(self, norm_nc: int, hidden_ncs: Sequence[int],
                 norm: str = "batch", ks: int = 1, params_free: bool = False):
        super().__init__()
        self.norm_nc = norm_nc
        self.ks = ks
        if "batch" in norm:
            self.norm = SyncBatchNorm(norm_nc, affine=False)
        else:
            self.norm = InstanceNorm(norm_nc, affine=False)
        for i, nc in enumerate(hidden_ncs):
            if params_free and i == 0:
                continue
            s = str(i + 1) if i > 0 else ""
            setattr(self, f"mlp_gamma{s}", nn.Conv2d(nc, norm_nc, ks, padding=ks // 2))
            setattr(self, f"mlp_beta{s}", nn.Conv2d(nc, norm_nc, ks, padding=ks // 2))

    def forward(self, x, maps, weights=None):
        if not isinstance(maps, (list, tuple)):
            maps = [maps]
        out = self.norm(x)
        nc = self.norm_nc
        for i, m in enumerate(maps):
            if m is None:
                continue
            m = resize_nearest(m, x.shape[2:])
            if weights is not None and i == 0:
                gb = batch_conv(m, torch.cat([weights[0], weights[1]], 1))
            else:
                s = str(i + 1) if i > 0 else ""
                g, b = getattr(self, f"mlp_gamma{s}"), getattr(self, f"mlp_beta{s}")
                gb = F.conv2d(m, torch.cat([g.weight, b.weight]),
                              torch.cat([g.bias, b.bias]), padding=self.ks // 2)
            out = out * (1 + gb[:, :nc]) + gb[:, nc:]
        return out


class SpadeConv2d(nn.Module):
    """conv -> plain norm -> leaky(0.2) (reference architecture.py:57-69)."""

    def __init__(self, cin: int, features: int, norm: str = "batch",
                 kernel_size: int = 3, stride: int = 1):
        super().__init__()
        self.conv = SNConv(cin, features, kernel_size, stride,
                           use_sn="spectral" in norm)
        self.bn = make_plain_norm(norm, features)

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return leaky_relu(x)


class SpadeResnetBlock(nn.Module):
    """Two-conv residual block with SPADE (or plain) norms
    (reference architecture.py:71-108).  With `conv_params_free` (the
    generator's adaptive_conv levels) the block owns no conv_0 / conv_1 /
    conv_s: each conv runs the per-sample (weight, bias) pair generated for
    it through batch_conv, conv_s with its bias too, as the JAX block does."""

    def __init__(self, fin: int, fout: int, norm: str = "batch",
                 hidden_ncs: Sequence[int] = (0,), conv_ks: int = 3,
                 spade_ks: int = 1, stride: int = 1,
                 conv_params_free: bool = False,
                 norm_params_free: bool = False):
        super().__init__()
        fhidden = min(fin, fout)
        self.learned_shortcut = fin != fout
        self.stride = stride
        self.conv_params_free = conv_params_free
        use_spade = "spade" in norm
        use_sn = "spectral" in norm

        def make_norm(features):
            if use_spade:
                return Spade(features, hidden_ncs, norm, spade_ks,
                             params_free=norm_params_free)
            return make_plain_norm(norm, features)

        if not conv_params_free:
            self.conv_0 = SNConv(fin, fhidden, conv_ks, stride, use_sn=use_sn)
            self.conv_1 = SNConv(fhidden, fout, conv_ks, use_sn=use_sn)
        self.bn_0 = make_norm(fin)
        self.bn_1 = make_norm(fhidden)
        if self.learned_shortcut:
            if not conv_params_free:
                self.conv_s = SNConv(fin, fout, 1, stride, bias=False, use_sn=use_sn)
            self.bn_s = make_norm(fin)
        self.use_spade = use_spade

    def _norm(self, bn, h, label, w):
        if bn is None:
            return h
        return bn(h, label, weights=w) if self.use_spade else bn(h)

    def _conv(self, name, h, w, stride=1):
        if self.conv_params_free:
            return batch_conv(h, w[0], w[1], stride=stride)
        return getattr(self, name)(h)

    def forward(self, x, label=None, norm_weights=None, conv_weights=None):
        """conv_weights: with conv_params_free, the generated [conv_0,
        conv_1, conv_s] pairs of (weight (B, Cout, Cin, k, k), bias (B, Cout))."""
        nw = norm_weights if norm_weights is not None else [None] * 3
        cw = conv_weights if conv_weights is not None else [None] * 3
        if self.conv_params_free and conv_weights is None:
            raise ValueError("a conv_params_free block needs its generated conv_weights")
        if self.learned_shortcut:
            x_s = self._conv("conv_s", self._norm(self.bn_s, x, label, nw[2]), cw[2],
                             self.stride)
        elif self.stride != 1:
            x_s = avg_pool(x, 3, 2, 1)
        else:
            x_s = x
        dx = self._conv("conv_0", leaky_relu(self._norm(self.bn_0, x, label, nw[0])),
                        cw[0], self.stride)
        dx = self._conv("conv_1", leaky_relu(self._norm(self.bn_1, dx, label, nw[1])),
                        cw[1])
        return x_s + dx
