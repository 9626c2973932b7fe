"""Checkpoint save and restore (port of fsvid2vid_tpu/training/checkpoint.py;
reference base_model.py:51-93 and models/models.py:48-62), with torch.save
in place of orbax.

The full train state is saved, as the JAX package saves it: the state dicts
of G, D and the temporal D (spectral u / v and batch-norm statistics are
buffers, so they are in them), both Adam states, the step, the VGG19
weights, and the (epoch, iter) cursor that replaces the reference's
`iter.txt`.  Layout: `<checkpoints_dir>/<name>/{latest,epoch_N}`, one file
each, plus `config.json`.  A file is written under a temporary name and
renamed, so a crash never leaves a truncated `latest`.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.training.state import ModelBundle, TrainState

NETWORKS = {"G": "netG", "D": "netD", "DT": "netDT", "vgg": "vgg"}


def ckpt_dir(cfg: Config) -> str:
    return os.path.abspath(os.path.join(cfg.checkpoints_dir, cfg.name))


def _payload(state: TrainState, epoch: int, epoch_iter: int) -> Dict:
    nets = {key: getattr(state.models, attr) for key, attr in NETWORKS.items()}
    return {"networks": {k: net.state_dict() for k, net in nets.items() if net is not None},
            "opt_G": state.opt_G.state_dict(), "opt_D": state.opt_D.state_dict(),
            "step": state.step, "cursor": {"epoch": epoch, "epoch_iter": epoch_iter}}


def save(cfg: Config, state: TrainState, epoch: int, epoch_iter: int = 0,
         label: Optional[str] = None) -> str:
    """Save under `label` (default 'latest'); also saves cfg JSON once."""
    base = ckpt_dir(cfg)
    os.makedirs(base, exist_ok=True)
    cfg_path = os.path.join(base, "config.json")
    if not os.path.exists(cfg_path):
        cfg.save(cfg_path)
    path = os.path.join(base, label or "latest")
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        torch.save(_payload(state, epoch, epoch_iter), tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def save_epoch(cfg: Config, state: TrainState, epoch: int) -> None:
    """latest + per-epoch snapshot.  The cursor records (epoch+1, 0) — the
    epoch is COMPLETE, resume starts the next one (models/models.py:61
    `np.savetxt(iter_path, (epoch+1, 0))`)."""
    save(cfg, state, epoch + 1, epoch_iter=0, label="latest")
    if cfg.save_epoch_freq and epoch % cfg.save_epoch_freq == 0:
        save(cfg, state, epoch + 1, epoch_iter=0, label=f"epoch_{epoch}")


@torch.no_grad()
def _load_matching(net: torch.nn.Module, stored: Dict[str, torch.Tensor]) -> None:
    """Copy the stored entries whose name and shape the network has into it;
    every other entry keeps its current value (base_model.py:84-85)."""
    own = net.state_dict()
    net.load_state_dict({k: v for k, v in stored.items()
                         if k in own and own[k].shape == v.shape}, strict=False)


def _opt_matches(opt: torch.optim.Optimizer, stored: Dict) -> bool:
    """Whether a stored optimizer state fits `opt`: as many groups, as many
    parameters in each, and moments of each parameter's shape."""
    groups = stored["param_groups"]
    if [len(g["params"]) for g in groups] != [len(g["params"]) for g in opt.param_groups]:
        return False
    params = [p for g in opt.param_groups for p in g["params"]]
    ids = [i for g in groups for i in g["params"]]
    for p, i in zip(params, ids):
        moments = stored["state"].get(i, {})
        if any(torch.is_tensor(v) and v.dim() and v.shape != p.shape
               for v in moments.values()):
            return False
    return True


def restore_models(models: ModelBundle, stored: Dict, keys=tuple(NETWORKS)) -> None:
    """Load the stored networks named in `keys` into `models`, in place;
    networks the bundle lacks (the discriminators of an inference build) are
    dropped."""
    for key in keys:
        net = getattr(models, NETWORKS[key])
        if net is not None and key in stored["networks"]:
            _load_matching(net, stored["networks"][key])


def load(cfg: Config, label: str = "latest",
         base_dir: Optional[str] = None) -> Optional[Dict]:
    """The stored checkpoint `label` (on the CPU), or None if there is none."""
    path = os.path.join(base_dir or ckpt_dir(cfg), label)
    if not os.path.isfile(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def restore(cfg: Config, state: TrainState, label: str = "latest",
            base_dir: Optional[str] = None) -> Tuple[bool, int, int]:
    """Load checkpoint `label` into `state`, in place: its modules'
    parameters and buffers, and the optimizers' state where it fits, so the
    optimizers keep referencing the same parameter tensors.  Returns
    (restored, epoch, epoch_iter); (False, 1, 0) if there is no checkpoint.

    Restore tolerates subsets both ways (base_model.py:68-93): entries the
    file lacks keep their current values, stored entries of another shape
    are ignored, networks the bundle lacks are dropped, and an optimizer
    state is loaded only when its parameter groups match.

    `base_dir` overrides the checkpoint directory (--load_pretrain)."""
    stored = load(cfg, label, base_dir)
    if stored is None:
        return False, 1, 0
    restore_models(state.models, stored)
    for name in ("opt_G", "opt_D"):
        opt = getattr(state, name)
        if name in stored and _opt_matches(opt, stored[name]):
            opt.load_state_dict(stored[name])
    state.step = int(stored.get("step", state.step))
    cur = stored["cursor"]
    return True, int(cur["epoch"]), int(cur["epoch_iter"])
