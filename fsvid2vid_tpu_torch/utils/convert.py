"""Carry weights across from the JAX package.

`state_dict_from_jax(variables, cfg)` takes the JAX FewShotGenerator's
{"params", "spectral", "batch_stats"} trees (nested dicts of numpy arrays)
and returns the port's state_dict, in the reference's torch names.  It is
the inverse of the JAX package's torch-checkpoint importer: flax module
paths map to torch keys the same way, conv kernels go from HWIO to
(Cout, Cin, kh, kw) and dense kernels from (in, out) to (out, in).

Pass the variables before spectral-norm folding: a kernel whose module has
u / v in "spectral" becomes `weight_orig`; fold on the port side
(inference.fold.fold_spectral_norm).
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
