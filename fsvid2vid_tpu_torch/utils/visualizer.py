"""Training visualisation (port of fsvid2vid_tpu/utils/visualizer.py;
reference util/visualizer.py): loss_log.txt, image dumps to <ckpt>/web/images
with an HTML gallery, and optional TensorBoard scalars.

In a process group only rank 0, the master, writes or prints anything
(util/distributed.py:45-52 master_only); a single process is its own
master."""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.parallel.mesh import is_master
from fsvid2vid_tpu_torch.utils.html import HTML
from fsvid2vid_tpu_torch.utils.imaging import (
    save_image, tensor2flow, tensor2im, tensor2label, tensor2pose)


def _host(x):
    """Tensors (any device, any float dtype) -> f32 numpy, through lists."""
    if isinstance(x, (list, tuple)):
        return [_host(e) for e in x]
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return x


def display_visuals(cfg: Config, vis) -> Dict[str, Optional[np.ndarray]]:
    """A train step's visuals (channel-last tensors) -> uint8 display images
    (reference models/trainer.py:96-111 save_all_tensors + util/util.py
    converters).  Batch entries are tiled into one grid per label."""
    vis = {k: _host(v) for k, v in vis.items()}
    out: Dict[str, Optional[np.ndarray]] = {}
    if cfg.label_nc > 0:
        out["input_label"] = tensor2label(vis["tgt_label"][0], cfg.label_nc)
        out["ref_label"] = tensor2label(vis["ref_label"][0], cfg.label_nc)
    elif cfg.is_pose:
        out["input_label"] = tensor2pose(vis["tgt_label"], tile=True)
        out["ref_label"] = tensor2pose(vis["ref_label"], tile=True)
    else:
        out["input_label"] = tensor2im(vis["tgt_label"], tile=True)
        out["ref_label"] = tensor2im(vis["ref_label"], tile=True)
    out["ref_image"] = tensor2im(vis["ref_image"], tile=True)
    out["real_image"] = tensor2im(vis["tgt_image"], tile=True)
    out["fake_image"] = tensor2im(vis["fake_image"], tile=True)
    if vis.get("fake_raw") is not None:
        out["fake_raw_image"] = tensor2im(vis["fake_raw"], tile=True)
    names = ["ref", "prev"]
    for i, w in enumerate(vis.get("warped") or []):
        if w is not None:
            out[f"warped_image_{names[i]}"] = tensor2im(w, tile=True)
    for i, f in enumerate(vis.get("flow") or []):
        if f is not None:
            out[f"flow_{names[i]}"] = tensor2flow(f[0])
    for i, m in enumerate(vis.get("flow_mask") or []):
        if m is not None:
            out[f"flow_mask_{names[i]}"] = tensor2im(m, normalize=False, tile=True)
    return out


class Visualizer:
    def __init__(self, cfg: Config, tb_log: bool = False):
        self.cfg = cfg
        self.ckpt_dir = os.path.join(cfg.checkpoints_dir, cfg.name)
        self.web_dir = os.path.join(self.ckpt_dir, "web")
        self.img_dir = os.path.join(self.web_dir, "images")
        self.tb = None
        if is_master():
            os.makedirs(self.img_dir, exist_ok=True)
            self.log_name = os.path.join(self.ckpt_dir, "loss_log.txt")
            with open(self.log_name, "a") as f:
                f.write(f"================ Training Loss "
                        f"({time.strftime('%c')}) ================\n")
            if tb_log:  # reference --tf_log (visualizer.py:94-112)
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self.tb = SummaryWriter(os.path.join(self.ckpt_dir, "tb"))
                except ImportError:
                    print("tensorboard unavailable; scalar logging disabled")

    def plot_current_errors(self, errors: Dict[str, float], step: int) -> None:
        """Scalar curves to TensorBoard (visualizer.py:167-171)."""
        if self.tb is not None:
            for k, v in errors.items():
                self.tb.add_scalar(k, float(v), step)

    def print_current_errors(self, epoch: int, i: int,
                             errors: Dict[str, float], t: float) -> None:
        if not is_master():
            return
        message = f"(epoch: {epoch}, iters: {i}, time: {t:.3f}) "
        for k, v in sorted(errors.items()):
            if v != 0:
                message += f"{k}: {v:.3f} "
        print(message)
        with open(self.log_name, "a") as f:
            f.write(message + "\n")

    def save_images(self, visuals: Dict[str, Optional[np.ndarray]],
                    epoch: int, step: int) -> None:
        """Dump a dict of uint8 images named <label>_epoch_step.png and
        refresh the HTML gallery (visualizer.py:114-164)."""
        if not is_master():
            return
        for label, image in visuals.items():
            if image is None:
                continue
            save_image(image,
                       os.path.join(self.img_dir,
                                    f"epoch{epoch:03d}_{step}_{label}.png"))
        self._rebuild_gallery()

    def _rebuild_gallery(self, max_rows: int = 30) -> None:
        names = sorted(os.listdir(self.img_dir), reverse=True)
        groups: Dict[str, list] = {}
        for n in names:
            key = "_".join(n.split("_")[:2])
            groups.setdefault(key, []).append(n)
        page = HTML(self.web_dir, f"training gallery: {self.cfg.name}")
        for key in list(groups)[:max_rows]:
            ims = groups[key]
            page.add_header(key)
            page.add_images(ims, [n.rsplit("_", 1)[-1] for n in ims], ims,
                            width=256)
        page.save()

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()

    @staticmethod
    def vis_print(message) -> None:
        if is_master():
            print(message)
