"""Carry weights across from the JAX package.

`state_dict_from_jax(variables, cfg)` takes the JAX FewShotGenerator's
{"params", "spectral", "batch_stats"} trees (nested dicts of numpy arrays)
and returns the port's state_dict, in the reference's torch names.  It is
the inverse of the JAX package's torch-checkpoint importer: flax module
paths map to torch keys the same way, conv kernels go from HWIO to
(Cout, Cin, kh, kw) and dense kernels from (in, out) to (out, in).

Pass the variables before spectral-norm folding: a kernel whose module has
u / v in "spectral" becomes `weight_orig`; fold on the port side
(inference.fold.fold_spectral_norm).  The train-time state (spectral u / v,
batch-norm running statistics) is carried like the parameters.

`discriminator_state_dict_from_jax`, `flownet2_state_dict_from_jax`,
`vgg_state_dict_from_jax` and `inception_state_dict_from_jax` do the same
for the other networks, as inverses of the JAX package's
import_discriminator, import_flownet2, import_vgg19 (also its
import_vgg_features, for the VGG16 of LPIPS) and import_inception.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from fsvid2vid_tpu_torch.config import Config

_LEAF = {"bias": "bias", "scale": "weight", "mean": "running_mean",
         "var": "running_var", "u": "weight_u", "v": "weight_v"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def torch_key(mods, cfg: Config) -> str:
    """Torch module prefix of a flax module path inside FewShotGenerator.

    Handles the weight-generation fc stacks (Sequential indices 2k and
    2 * n_fc_layers), the embedders' Sequential wrappers (conv at .0 for
    conv_first / down, .1 for up behind an Upsample), the flow networks'
    flat Sequentials, and the attribute-named modules, which match 1:1."""
    mods = list(mods)
    out = []
    i = 0
    while i < len(mods):
        m = mods[i]
        tok = m.rsplit("_", 1)[-1]
        if m.startswith(("fc_spade_", "fc_conv_")) and (
                (tok.startswith("l") and tok[1:].isdigit()) or tok == "out"):
            base, suffix = m.rsplit("_", 1)
            idx = 2 * cfg.n_fc_layers if suffix == "out" else 2 * int(suffix[1:])
            out.append(f"{base}.{idx}")
            i += 1
            continue
        if m in ("label_embedding", "img_ref_embedding", "img_prev_embedding"):
            nxt = mods[i + 1]
            if nxt == "conv_first" or nxt.startswith("down_"):
                out += [m, f"{nxt}.0"]
            elif nxt.startswith("up_"):
                out += [m, f"{nxt}.1"]
            else:
                out += [m, nxt]
            i += 2
            continue
        if m in ("flow_network_ref", "flow_network_temp"):
            nxt = mods[i + 1]
            nd = cfg.n_downsample_F
            part = nxt.rsplit("_", 1)[-1]
            sub = {"conv": "0", "norm": "1"}.get(part)
            if nxt.startswith("down_first_"):
                out += [m, f"down_flow.0.{sub}"]
            elif nxt.startswith("down_") and sub:
                j = int(nxt.split("_")[1])
                out += [m, f"down_flow.{2 * (j + 1)}.{sub}"]
            elif nxt.startswith("up_") and sub:
                j = int(nxt.split("_")[1])
                out += [m, f"up_flow.{3 * (nd - 1 - j) + 1}.{sub}"]
            elif nxt.startswith("res_"):
                out += [m, f"res_flow.{int(nxt.split('_')[1])}"]
            elif nxt in ("conv_flow", "conv_mask"):
                out += [m, f"{nxt}.0"]
            else:
                out += [m, nxt]
            i += 2
            continue
        out.append(m)
        i += 1
    return ".".join(out)


def state_dict_from_jax(variables: Mapping, cfg: Config) -> Dict[str, torch.Tensor]:
    """The port's FewShotGenerator state_dict from JAX variables."""
    spectral = variables.get("spectral", {})
    sn_modules = {path[:-1] for path, _ in _leaves(spectral)}
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "spectral", "batch_stats"):
        for path, value in _leaves(variables.get(coll, {})):
            mods, leaf = path[:-1], path[-1]
            prefix = torch_key(mods, cfg)
            w = np.asarray(value, np.float32)
            if leaf == "kernel":
                name = "weight_orig" if mods in sn_modules else "weight"
                w = np.transpose(w, (3, 2, 0, 1)) if w.ndim == 4 else w.T
            else:
                name = _LEAF[leaf]
            head = f"{prefix}." if prefix else ""
            sd[head + name] = torch.tensor(w)
            if leaf == "mean":
                sd[head + "num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    # a shared network is registered under both names, as in the reference
    aliases = []
    if cfg.warp_ref and cfg.n_frames_G > 1 and cfg.flow_temp_is_shared:
        aliases.append(("flow_network_ref.", "flow_network_temp."))
    if cfg.warp_ref and cfg.n_frames_G > 1 and cfg.prev_embedding_is_shared:
        aliases.append(("img_ref_embedding.", "img_prev_embedding."))
    for src, dst in aliases:
        for k in [k for k in sd if k.startswith(src)]:
            sd[dst + k[len(src):]] = sd[k]
    return sd


def _convert(leaf: str, value, is_sn: bool = False):
    """(torch leaf name, array) of one flax leaf of a plain or spectral conv
    / dense / norm module."""
    w = np.asarray(value, np.float32)
    if leaf == "kernel":
        w = np.transpose(w, (3, 2, 0, 1)) if w.ndim == 4 else w.T
        return ("weight_orig" if is_sn else "weight"), w
    return _LEAF[leaf], w


def discriminator_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's MultiscaleDiscriminator state_dict from JAX variables
    ({"params", "spectral"}); the image, temporal and face discriminators
    (params_D["D"], ["DT"], ["Df"]) share the naming.  flax `discriminator_K/modelN_conv` is the
    reference's `discriminator_K.modelN.0` for the first and the last layer
    and `.modelN.0.0` for the middle ones, whose norm is `.modelN.0.1`."""
    sn_modules = {path[:-1] for path, _ in _leaves(variables.get("spectral", {}))}
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "spectral"):
        tree = variables.get(coll, {})
        for disc, layers in tree.items():
            last = max(int(name[len("model"):-len("_conv")])
                       for name in variables["params"][disc] if name.endswith("_conv"))
            for path, value in _leaves(layers):
                module, leaf = path[0], path[-1]
                n, kind = module[len("model"):].rsplit("_", 1)
                middle = 0 < int(n) < last
                if kind == "norm":
                    prefix = f"{disc}.model{n}.0.1"
                else:
                    prefix = f"{disc}.model{n}.0" + (".0" if middle else "")
                name, w = _convert(leaf, value, (disc, module) in sn_modules)
                sd[f"{prefix}.{name}"] = torch.tensor(w)
    return sd


def flownet2_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's FlowNet2 state_dict (the reference checkpoint's names) from
    the JAX FlowNet2 parameters.  `<layer>/conv` and `<layer>/deconv` are the
    Sequential's `<layer>.0`; transposed-conv kernels (deconv*,
    upsampled_flow*) go from the flipped HWIO of the JAX formulation back to
    torch's (Cin, Cout, kh, kw)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        mods, leaf = path[:-1], path[-1]
        transposed = any(m == "deconv" or m.startswith("upsampled_flow") for m in mods)
        prefix = ".".join("0" if m in ("conv", "deconv") else m for m in mods)
        w = np.asarray(value, np.float32)
        if leaf == "kernel":
            if transposed:
                w = np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[:, :, ::-1, ::-1])
            else:
                w = np.transpose(w, (3, 2, 0, 1))
        sd[f"{prefix}.{'weight' if leaf == 'kernel' else 'bias'}"] = torch.tensor(w)
    return sd


def vgg_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """torchvision's `features.N.*` state dict of a VGG trunk from the JAX
    parameters (`conv_N/{kernel,bias}`): the port's Vgg19Features from the
    JAX Vgg19Features, or the LPIPS Vgg16Features from the JAX one."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        name, w = _convert(path[-1], value)
        sd[f"features.{path[-2].split('_')[1]}.{name}"] = torch.tensor(w)
    return sd


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch state dict file, also one that holds it under "state_dict"."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "state_dict" in payload:
        payload = payload["state_dict"]
    return payload


def load_trunk(net: torch.nn.Module, path: str) -> torch.nn.Module:
    """A state dict file in the layout `net` names (torchvision's for VGG19,
    VGG16 and InceptionV3) into `net`, strictly over the keys `net` has:
    every one must be in the file, whose classifier, auxiliary head or
    deeper layers stay unused."""
    sd = load_torch_state_dict(path)
    net.load_state_dict({k: v for k, v in sd.items() if k in net.state_dict()}, strict=True)
    return net


_BN_LEAF = {"bn_scale": "weight", "bn_bias": "bias", "bn_mean": "running_mean",
            "bn_var": "running_var"}


def inception_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """torchvision's inception_v3 trunk state dict (the port's
    InceptionV3Pool3) from the JAX InceptionV3Pool3 parameters: each
    BasicConv2d's `conv/kernel` is `<path>.conv.weight`, its `bn_*` leaves
    `<path>.bn.*`, with the `num_batches_tracked` counter a torchvision
    file holds."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        w = np.asarray(value, np.float32)
        if path[-1] == "kernel":
            sd[".".join(path[:-2]) + ".conv.weight"] = torch.tensor(np.transpose(w, (3, 2, 0, 1)))
        else:
            prefix = ".".join(path[:-1]) + ".bn"
            sd[f"{prefix}.{_BN_LEAF[path[-1]]}"] = torch.tensor(w)
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return sd
