"""Flow teacher (port of fsvid2vid_tpu/training/flow_teacher.py, reference
models/flownet.py): the frozen FlowNet2 gives every training iteration its
flow ground truth,

  * the flow to the previous frame, once the temporal phase has begun
    (epoch > niter_single), and
  * the flow to the first reference image when warp_ref,

on the real images (face, street), with the confidence
(||im1 - warp(im2, flow)||^2 < 0.02).  Images are resized bilinearly to
multiples of 64 for the network and the flows scaled back.  Always f32 and
without gradient.  The pretrained checkpoint is not bundled: without it the
network runs with seeded random weights, as the JAX package does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from fsvid2vid_tpu_torch import resolve_device
from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.models import build_on_device, init_plain_convs
from fsvid2vid_tpu_torch.models.flownet.flownet2 import FlowNet2
from fsvid2vid_tpu_torch.ops.image_ops import resize_bilinear
from fsvid2vid_tpu_torch.ops.warp import flow_warp

CONF_THRESHOLD = 0.02


@torch.no_grad()
def compute_flow_and_conf(model: FlowNet2, im1: torch.Tensor, im2: torch.Tensor):
    """Flow from im1 to im2 and its confidence (reference flownet.py:64-79).
    im1, im2: (B, 3, H, W) in about [-1, 1]; returns (flow (B, 2, H, W),
    conf (B, 1, H, W)), both f32."""
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
    each entry (B, T, H, W, 2 | 1) or None, channels last as in the batch.

    The network sits on `device` (CUDA unless the caller names another),
    initialised from `generator` (a CPU torch.Generator; seed cfg.seed when
    None) unless `state_dict` (the reference checkpoint's) is given."""

    def __init__(self, cfg: Config, device=None,
                 generator: Optional[torch.Generator] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None):
        if cfg.is_pose:
            raise NotImplementedError("the pose teacher (flow on the label "
                                      "map) is not ported")
        self.device = resolve_device(device)
        model = build_on_device(FlowNet2, self.device)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        else:
            if generator is None:
                generator = torch.Generator().manual_seed(cfg.seed)
            init_plain_convs(model, generator)
        self.model = model.eval().requires_grad_(False)

    def __call__(self, cfg: Config, seq: Dict, epoch: int):
        to = dict(device=self.device, dtype=torch.float32)
        image_now = torch.as_tensor(seq["tgt_image"], **to)[..., :3]   # (B, T, H, W, 3)
        image_ref = torch.as_tensor(seq["ref_images"], **to)[:, 0, ..., :3]
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
