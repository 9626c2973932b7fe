"""Seeded weights, made on the device in a few large draws.

Every parameter and buffer of a network is filled from one `torch.Generator`
on the network's device: one normal draw and one uniform draw cover all of
its tensors, sliced in the order of `named_modules`.  The rules follow the
port's initialisation (fsvid2vid_tpu_torch/models/__init__.py) by tensor
name, so the program's networks and the reference's copies of them, which
share every name and shape, receive the same values from the same seed:

  * G and D (`plain=False`): weights with two or more axes (spectral-norm
    `weight_orig` too) xavier-normal with gain `gain`; one-axis weights (the
    norms' scales) 1 + gain * N(0, 1); biases 0; spectral-norm u / v the
    leading singular vectors after 10 power iterations from a random u;
    running statistics 0 / 1, or with `random_stats` 0.1 * N(0, 1) and
    0.5 + U(0, 1), as a trained network's are not;
  * the stand-ins for pretrained networks (VGG19, FlowNet2; `plain=True`):
    conv weights N(0, 1 / fan_in), transposed-conv weights xavier-uniform,
    biases 0.
"""
from __future__ import annotations

import math
from typing import Iterator, Tuple

import torch
import torch.nn as nn

SN_POWER_ITERS = 10


def _tensors(net: nn.Module) -> Iterator[Tuple[nn.Module, str, torch.Tensor]]:
    for m in net.modules():
        for name, t in list(m.named_parameters(recurse=False)) + \
                list(m.named_buffers(recurse=False)):
            yield m, name, t


def _kind(m: nn.Module, name: str, t: torch.Tensor, plain: bool) -> str:
    if name in ("weight", "weight_orig") and t.dim() >= 2:
        if plain and isinstance(m, nn.ConvTranspose2d):
            return "uniform_xavier"
        return "fan_in" if plain else "xavier"
    if name == "weight" and t.dim() == 1:
        return "scale"
    if name in ("bias", "num_batches_tracked"):
        return "zero"
    if name in ("weight_u", "weight_v", "running_mean", "running_var"):
        return name
    raise ValueError(f"no seeded rule for {type(m).__name__}.{name} {tuple(t.shape)}")


def _l2normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (x.norm() + 1e-12)


@torch.no_grad()
def fill(net: nn.Module, seed: int, gain: float = 0.02, plain: bool = False,
         random_stats: bool = False) -> nn.Module:
    """Fill every parameter and buffer of `net` (on one device) from `seed`.
    Returns `net`."""
    device = next(net.parameters()).device
    g = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    entries = [(m, name, t, _kind(m, name, t, plain)) for m, name, t in _tensors(net)]
    # the normal draw covers weights, scales, the power iterations' starts
    # and the running means; the uniform one the transposed convs and the
    # running variances
    n_normal = sum(t.numel() for _, _, t, k in entries
                   if k in ("xavier", "fan_in", "scale", "weight_u", "running_mean"))
    n_uniform = sum(t.numel() for _, _, t, k in entries
                    if k in ("uniform_xavier", "running_var"))
    normal = torch.randn(max(n_normal, 1), generator=g, device=device)
    uniform = torch.rand(max(n_uniform, 1), generator=g, device=device)
    pos = {"n": 0, "u": 0}

    def take(src, key, t):
        n = t.numel()
        out = (normal if src == "n" else uniform)[pos[key]:pos[key] + n].view(t.shape)
        pos[key] += n
        return out

    sn = {}   # module -> its u draw, resolved after weight_orig is filled
    for m, name, t, kind in entries:
        shape = tuple(t.shape)
        if kind in ("xavier", "fan_in", "uniform_xavier"):
            rf = math.prod(shape[2:])
            if kind == "xavier":
                std = gain * math.sqrt(2.0 / (shape[1] * rf + shape[0] * rf))
                t.copy_(take("n", "n", t) * std)
            elif kind == "fan_in":
                t.copy_(take("n", "n", t) / math.sqrt(shape[1] * rf))
            else:   # ConvTranspose2d (in, out, kh, kw)
                limit = math.sqrt(6.0 / (rf * (shape[0] + shape[1])))
                t.copy_((take("u", "u", t) * 2 - 1) * limit)
        elif kind == "scale":
            t.copy_(1.0 + gain * take("n", "n", t))
        elif kind == "zero":
            t.zero_()
        elif kind == "weight_u":
            sn[m] = take("n", "n", t)
        elif kind == "weight_v":
            pass
        elif kind == "running_mean":
            draw = take("n", "n", t)
            t.copy_(0.1 * draw if random_stats else torch.zeros_like(draw))
        elif kind == "running_var":
            draw = take("u", "u", t)
            t.copy_(0.5 + draw if random_stats else torch.ones_like(draw))
    for m, u0 in sn.items():
        mat = m.weight_orig.float().reshape(m.weight_orig.shape[0], -1)
        u = _l2normalize(u0)
        v = _l2normalize(mat.t() @ u)
        for _ in range(SN_POWER_ITERS):
            v = _l2normalize(mat.t() @ u)
            u = _l2normalize(mat @ v)
        m.weight_u.copy_(u)
        m.weight_v.copy_(v)
    return net


@torch.no_grad()
def focus_attention(netG: nn.Module, n_downsample_A: int, sharpen: float) -> None:
    """The key encoders take the query encoders' weights, and the last
    key and query norms' scales are multiplied by `sharpen`: the reference
    whose label a driving label follows then draws the attention clearly,
    as in a trained model, where random weights leave the K masses nearly
    tied and the argmax to rounding."""
    for part in ["first"] + list(range(n_downsample_A)):
        getattr(netG, f"atn_key_{part}").load_state_dict(
            getattr(netG, f"atn_query_{part}").state_dict())
    for kind in ("key", "query"):
        getattr(netG, f"atn_{kind}_{n_downsample_A - 1}").bn.weight.mul_(sharpen)
