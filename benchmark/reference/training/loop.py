"""The reference's walk through one training sequence, as the port's
`Trainer.train_epoch` (fsvid2vid_tpu_torch/training/trainer.py) takes it in
the temporal phase: the temporal flow network and previous-frame embedding
copied from their reference-branch twins at the transition, the teacher's
flows for the whole sequence, then one `train_step` per frame with the
previous-frames buffers, at the epoch's learning rates."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from benchmark.reference.config import Config
from benchmark.reference.training.state import ModelBundle, TrainState, set_epoch_lr
from benchmark.reference.training.step import StepFlags, init_prevs, train_step


@torch.no_grad()
def copy_temporal_params(cfg: Config, models: ModelBundle) -> None:
    """Every parameter of the same name and shape copied in place from the
    reference-branch flow network / embedding to the temporal one."""
    g = models.netG

    def copy_matching(src_name, dst_name):
        src, dst = getattr(g, src_name, None), getattr(g, dst_name, None)
        if src is None or dst is None or src is dst:
            return
        params = dict(src.named_parameters())
        for name, p in dst.named_parameters():
            if name in params and params[name].shape == p.shape:
                p.copy_(params[name])

    if not cfg.flow_temp_is_shared and cfg.warp_ref:
        copy_matching("flow_network_ref", "flow_network_temp")
    if cfg.spade_combine and not cfg.prev_embedding_is_shared and cfg.warp_ref:
        copy_matching("img_ref_embedding", "img_prev_embedding")


def run_sequence(cfg: Config, state: TrainState, seq: Dict[str, torch.Tensor],
                 epoch: int, teacher, steps: int,
                 after_step: Optional[Callable[[int, Dict], None]] = None):
    """The first `steps` per-frame steps of `seq` (B, T, ...) at `epoch`;
    `after_step(t, losses)` sees each step's f32 losses."""
    set_epoch_lr(cfg, state, epoch)
    warp_prev = epoch > cfg.niter_single and cfg.n_frames_G > 1
    flow_gt, conf_gt = ([None, None], [None, None]) if teacher is None \
        else teacher(cfg, seq, epoch)
    at = lambda xs, t: [None if x is None else x[:, t] for x in xs]
    prevs = None
    for t in range(steps):
        batch = {"tgt_label": seq["tgt_label"][:, t], "tgt_image": seq["tgt_image"][:, t],
                 "ref_labels": seq["ref_labels"], "ref_images": seq["ref_images"],
                 "flow_gt": at(flow_gt, t), "conf_gt": at(conf_gt, t)}
        if prevs is None:
            prevs = init_prevs(cfg, batch)
        flags = StepFlags(warp_prev=warp_prev, has_prev=warp_prev and t > 0)
        prevs, losses, _ = train_step(cfg, state, batch, prevs, flags,
                                      compute_dtype="float32")
        if after_step is not None:
            after_step(t, losses)
