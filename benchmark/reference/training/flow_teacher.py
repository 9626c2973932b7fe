"""Flow teacher of the reference (the port's
fsvid2vid_tpu_torch/training/flow_teacher.py, copied without its
initialisation): the frozen FlowNet2, with the plain correlation, gives
each training frame its flow ground truth to the previous frame (temporal
phase) and to the first reference (warp_ref), with the confidence
(||im1 - warp(im2, flow)||^2 < 0.02).  Always f32 and without gradient."""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.config import Config
from benchmark.reference.models.flownet.flownet2 import FlowNet2
from benchmark.reference.ops.image_ops import resize_bilinear
from benchmark.reference.ops.warp import flow_warp
from benchmark.reference.training.state import build_on_device

CONF_THRESHOLD = 0.02


@torch.no_grad()
def compute_flow_and_conf(model: FlowNet2, im1: torch.Tensor, im2: torch.Tensor):
    """Flow from im1 to im2 and its confidence; im1, im2 (B, 3, H, W)."""
    with torch.autocast(im1.device.type, enabled=False):
        im1, im2 = im1.float(), im2.float()
        h, w = im1.shape[-2:]
        nh, nw = h // 64 * 64, w // 64 * 64
        im1r, im2r = resize_bilinear(im1, (nh, nw)), resize_bilinear(im2, (nh, nw))
        flow = model(im1r, im2r)
        err = im1r - flow_warp(im2r, flow)
        conf = (err.square().sum(1, keepdim=True) < CONF_THRESHOLD).float()
        if (nh, nw) != (h, w):
            flow = resize_bilinear(flow, (h, w)) * (h / nh)
            conf = resize_bilinear(conf, (h, w))
        return flow, conf


class FlowTeacher:
    """teacher(cfg, seq, epoch) -> (flow_gt [ref, prev], conf_gt [ref, prev]),
    each entry (B, T, H, W, 2 | 1) or None, channels last."""

    def __init__(self, device):
        self.device = None if device is None else torch.device(device)
        self.model = build_on_device(FlowNet2, self.device).eval().requires_grad_(False)

    def __call__(self, cfg: Config, seq: Dict, epoch: int):
        to = dict(device=self.device, dtype=torch.float32)
        now, ref = ("tgt_label", "ref_labels") if cfg.is_pose else ("tgt_image", "ref_images")
        image_now = torch.as_tensor(seq[now], **to)[..., :3]
        image_ref = torch.as_tensor(seq[ref], **to)[:, 0, ..., :3]
        flow_prev = conf_prev = flow_ref = conf_ref = None
        if not cfg.is_train or epoch > cfg.niter_single:
            image_prev = torch.cat([image_now[:, 0:1], image_now[:, :-1]], 1)
            flow_prev, conf_prev = self._flow_seq(image_now, image_prev)
        if cfg.warp_ref:
            flow_ref, conf_ref = self._flow_seq(
                image_now, image_ref[:, None].expand_as(image_now))
        return [flow_ref, flow_prev], [conf_ref, conf_prev]

    def _flow_seq(self, a, b):
        bsz, t = a.shape[:2]
        flow, conf = compute_flow_and_conf(
            self.model, a.flatten(0, 1).permute(0, 3, 1, 2).contiguous(),
            b.flatten(0, 1).permute(0, 3, 1, 2).contiguous())
        return (flow.permute(0, 2, 3, 1).unflatten(0, (bsz, t)),
                conf.permute(0, 2, 3, 1).unflatten(0, (bsz, t)))
