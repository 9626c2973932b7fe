"""Training loop: epochs, temporal curriculum, checkpoint cadence and
loss logging (port of fsvid2vid_tpu/training/trainer.py; reference
train.py:19-68, models/trainer.py and the schedule helpers of
models/models.py:64-76).

Curriculum:
  * epochs 1..niter_single: single-frame phase (warp_prev off);
  * epoch niter_single + 1: the temporal phase starts (warp_prev on); if
    the temporal flow network or the previous-frame embedding is separate,
    its parameters are copied from the reference branch
    (generator.py:176 load_pretrained_net);
  * every niter_step epochs the sampled sequence length doubles, up to 30
    (base_dataset.py:22-27);
  * the learning rate decays linearly after `niter` epochs.

One device, no mesh: data parallelism is a later port.  Per sequence the
host does three things beside the steps: one copy of the batch to the
device, one teacher call, and one transfer of the sequence's losses back.
That transfer waits for the device, so the trainer times each sequence on
the host clock without a synchronise of its own (`Trainer.timings`).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional

import torch

from fsvid2vid_tpu_torch import resolve_device
from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.training import checkpoint as ckpt_lib
from fsvid2vid_tpu_torch.training.state import (
    ModelBundle, TrainState, build_models, set_epoch_lr)
from fsvid2vid_tpu_torch.training.step import (
    StepFlags, init_prevs, train_step, train_step_faithful)
from fsvid2vid_tpu_torch.utils.image_pool import ImagePool
from fsvid2vid_tpu_torch.utils.visualizer import display_visuals

SEQUENCE_KEYS = ("tgt_label", "tgt_image", "ref_labels", "ref_images")


def n_frames_total_for_epoch(cfg: Config, epoch: int) -> int:
    """Sequence-length curriculum: double every niter_step epochs past
    niter_single, capped at 30 (models/models.py:72-76, base_dataset.py:22-27)."""
    if epoch <= cfg.niter_single:
        return 1
    n_doublings = (epoch - cfg.niter_single - 1) // cfg.niter_step + 1
    return min(cfg.n_frames_total * (2 ** max(0, n_doublings - 1)), 30)


@torch.no_grad()
def copy_temporal_params(cfg: Config, models: ModelBundle) -> None:
    """At the temporal transition, initialise the separate previous-frame
    flow network and embedding from their reference-branch twins
    (generator.py:162-177 init_temporal_network): every parameter of the
    same name and shape is copied in place, so the optimizer keeps training
    the same tensors.  Buffers (spectral u / v, batch statistics) keep their
    own values, as in the JAX package."""
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


def to_device(seq: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy, channel-last) on `device`: one copy per array
    for the whole sequence."""
    return {k: torch.as_tensor(seq[k]).to(device, non_blocking=True)
            for k in SEQUENCE_KEYS}


class Trainer:
    def __init__(self, cfg: Config, models: Optional[ModelBundle] = None,
                 log_fn: Callable[[str], None] = print, visualizer=None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.models = models or build_models(cfg, device=self.device)
        self.log = log_fn
        self.vis = visualizer  # utils.visualizer.Visualizer or None
        self.state: Optional[TrainState] = None
        self.start_epoch = 1
        self.epoch_iter = 0
        self.global_step = 0  # TensorBoard x-axis
        # per sequence: epoch, iter, frames, the ms spent waiting for the data
        # iterator, and the ms from its batch to its losses on the host
        # (batch copy, teacher, steps)
        self.timings: List[Dict] = []
        self.epoch_metrics: Dict[int, Dict[str, float]] = {}
        self._temporal_initialized = False
        self.pool = ImagePool(cfg.pool_size, seed=cfg.seed) if cfg.pool_size > 0 else None
        self.step_fn = train_step_faithful if cfg.step_mode == "faithful" else train_step

    # ------------------------------------------------------------------
    def setup(self) -> TrainState:
        """The train state, resumed from `latest` with continue_train, or
        warm-started from load_pretrain's weights."""
        cfg = self.cfg
        self.state = TrainState(cfg, self.models)
        restored = False
        if cfg.continue_train:
            restored, epoch, it = ckpt_lib.restore(cfg, self.state)
            if restored:
                self.start_epoch, self.epoch_iter = epoch, it
                self.log(f"resumed from epoch {epoch} iter {it}")
        if not restored and cfg.load_pretrain:
            # --load_pretrain: warm-start G and D (and their norm / spectral
            # buffers) from another experiment's checkpoint directory; the
            # optimizers and the schedule start fresh (train_options.py:16,
            # base_model.py:57-66)
            stored = ckpt_lib.load(cfg, base_dir=cfg.load_pretrain)
            if stored is not None:
                ckpt_lib.restore_models(self.models, stored, keys=("G", "D", "DT"))
                self.log(f"warm-started weights from {cfg.load_pretrain}")
            else:
                self.log(f"WARNING: --load_pretrain dir {cfg.load_pretrain} "
                         "has no 'latest' checkpoint")
        return self.state

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int, data_iter: Iterable[Dict],
                    flow_teacher=None) -> Dict[str, float]:
        """Run one epoch.  data_iter yields sequence batches:
        {tgt_label (B,T,H,W,C), tgt_image (B,T,H,W,3), ref_labels, ref_images}
        as numpy arrays or tensors."""
        cfg = self.cfg
        set_epoch_lr(cfg, self.state, epoch)
        warp_prev = epoch > cfg.niter_single and cfg.n_frames_G > 1
        # mid-epoch resume: skip the iterations done before the interruption
        # (reference trainer.py:27-30 + iter.txt cursor)
        start_iter = self.epoch_iter if epoch == self.start_epoch else 0
        if warp_prev and not self._temporal_initialized:
            # the copy happens once, at the transition; a checkpoint written
            # later already holds the copied (and trained) parameters
            if epoch == cfg.niter_single + 1 and start_iter == 0:
                copy_temporal_params(cfg, self.models)
            self._temporal_initialized = True
            self.log("---------- temporal phase begins ----------")
        if start_iter:
            self.log(f"skipping {start_iter} already-completed iters "
                     f"of epoch {epoch}")

        losses_accum: Dict[str, float] = {}
        count = 0
        t0 = time.time()
        bs = max(cfg.batch_size, 1)
        t_asked = time.perf_counter()
        for idx, seq in enumerate(data_iter):
            t_got = time.perf_counter()
            if idx < start_iter:
                t_asked = time.perf_counter()
                continue
            seq = to_device(seq, self.device)
            T = seq["tgt_label"].shape[1]
            # teacher pseudo-GT flow for the whole sequence
            flow_gt_seq, conf_gt_seq = [None, None], [None, None]
            if flow_teacher is not None and not cfg.no_flow_gt:
                flow_gt_seq, conf_gt_seq = flow_teacher(cfg, seq, epoch)
            at = lambda xs, t: [None if x is None else x[:, t] for x in xs]

            prevs = None
            seq_losses: Dict[str, torch.Tensor] = {}
            visuals = None
            for t in range(T):
                batch_t = {"tgt_label": seq["tgt_label"][:, t],
                           "tgt_image": seq["tgt_image"][:, t],
                           "ref_labels": seq["ref_labels"],
                           "ref_images": seq["ref_images"],
                           "flow_gt": at(flow_gt_seq, t), "conf_gt": at(conf_gt_seq, t)}
                if self.pool is not None:
                    b, h, w = batch_t["tgt_image"].shape[:3]
                    pf, pm = self.pool.begin_step(b, (h, w, 3))
                    batch_t["pool_fake"] = torch.from_numpy(pf).to(self.device)
                    batch_t["pool_mask"] = torch.from_numpy(pm).to(self.device)
                if prevs is None:
                    prevs = init_prevs(cfg, batch_t)
                flags = StepFlags(warp_prev=warp_prev, has_prev=warp_prev and t > 0,
                                  use_pool=self.pool is not None)
                prevs, losses, visuals = self.step_fn(
                    cfg, self.state, batch_t, prevs, flags,
                    compute_dtype=cfg.compute_dtype)
                if self.pool is not None:
                    self.pool.commit(visuals["fake_image"].float().cpu().numpy())
                # summed on the device; averaged over ALL frames of the
                # sequence (not just the last) below
                for k, v in losses.items():
                    seq_losses[k] = seq_losses[k] + v if k in seq_losses else v
            keys = sorted(seq_losses)
            values = (torch.stack([seq_losses[k] for k in keys]) / T).cpu().tolist()
            self.timings.append(dict(epoch=epoch, iter=idx + 1, frames=T,
                                     wait_ms=1e3 * (t_got - t_asked),
                                     ms=1e3 * (time.perf_counter() - t_got)))
            for k, v in zip(keys, values):
                losses_accum[k] = losses_accum.get(k, 0.0) + v
            count += 1
            self.global_step += 1
            iters_done = idx + 1
            if cfg.print_freq and iters_done % max(1, cfg.print_freq // bs) == 0:
                dt = (time.time() - t0) / max(count, 1)
                avg = {k: v / count for k, v in losses_accum.items()}
                if self.vis is not None:
                    self.vis.print_current_errors(epoch, iters_done, avg, dt)
                    self.vis.plot_current_errors(avg, self.global_step)
                else:
                    msg = " ".join(f"{k}:{v:.3f}" for k, v in sorted(avg.items()))
                    self.log(f"epoch {epoch} iter {iters_done} ({dt:.2f}s/it) {msg}")
            # display_freq image dumps (reference trainer.py:53-56 +
            # save_all_tensors :96-111): the last frame of this sequence
            if (self.vis is not None and cfg.display_freq
                    and iters_done % max(1, cfg.display_freq // bs) == 0):
                self.vis.save_images(display_visuals(cfg, visuals), epoch, iters_done)
            # mid-epoch 'latest' checkpoint with the iter cursor (reference
            # save_latest_freq, models/models.py:48-62)
            if (cfg.save_latest_freq
                    and iters_done % max(1, cfg.save_latest_freq // bs) == 0):
                ckpt_lib.save(cfg, self.state, epoch, epoch_iter=iters_done,
                              label="latest")
                self.log(f"saved latest (epoch {epoch}, iter {iters_done})")
            t_asked = time.perf_counter()
        self.epoch_iter = 0  # epoch completed; next epoch starts clean
        ckpt_lib.save_epoch(cfg, self.state, epoch)
        return {k: v / max(count, 1) for k, v in losses_accum.items()}

    # ------------------------------------------------------------------
    def fit(self, make_data_iter: Callable[[int, int], Iterable],
            flow_teacher=None) -> TrainState:
        """Full schedule: make_data_iter(epoch, n_frames_total) -> iterable."""
        cfg = self.cfg
        for epoch in range(self.start_epoch, cfg.niter + cfg.niter_decay + 1):
            nft = n_frames_total_for_epoch(cfg, epoch)
            metrics = self.epoch_metrics[epoch] = self.train_epoch(
                epoch, make_data_iter(epoch, nft), flow_teacher)
            self.log(f"epoch {epoch} done: " + " ".join(
                f"{k}:{v:.3f}" for k, v in sorted(metrics.items())))
        return self.state
