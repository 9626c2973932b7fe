"""Face boxes and face crops of pose labels (port of the box and crop part
of fsvid2vid_tpu/models/face_refiner.py; reference models/face_refiner.py).

The reference finds each sample's face box with `.nonzero()` and Python
ints (face_refiner.py:54-86); here, as in the JAX package, the box comes
from masked min / max reductions and the crop is a fixed-shape bilinear
sample (ops/crop.py), so boxes and crops stay on the device.  Channel-last.
The face generator that refines the crop (`refine_face`) is not ported.
"""
from __future__ import annotations

import torch

from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.ops.crop import crop_resize


def face_size_of(cfg: Config) -> int:
    """Side of the square face crop (face_refiner.py:21)."""
    return int(cfg.fine_size / cfg.aspect_ratio) // 4


def get_face_boxes(cfg: Config, pose: torch.Tensor,
                   crop_smaller: int = 0) -> torch.Tensor:
    """Per-sample face boxes [ys, ye, xs, xe) as (B, 4) f32.

    pose: (B, H, W, C) raw label.  The face pixels are the OpenPose face
    edges (all of the last three channels > 0), or, with basic_point_only or
    remove_face_labels, the DensePose face parts (channel 2 > 0.9).  A
    sample without face pixels gets the fallback box of face_refiner.py:77-80."""
    b, h, w, _ = pose.shape
    use_openpose = not cfg.basic_point_only and not cfg.remove_face_labels
    if use_openpose:
        cond = (pose[..., -3] > 0) & (pose[..., -2] > 0) & (pose[..., -1] > 0)
    else:
        cond = pose[..., 2] > 0.9
    f32 = dict(dtype=torch.float32, device=pose.device)
    yy = torch.arange(h, **f32)[None, :, None].expand(b, h, w)
    xx = torch.arange(w, **f32)[None, None, :].expand(b, h, w)
    big = torch.tensor(1e9, **f32)
    ys = torch.where(cond, yy, big).amin((1, 2))
    ye = torch.where(cond, yy, -big).amax((1, 2))
    xs = torch.where(cond, xx, big).amin((1, 2))
    xe = torch.where(cond, xx, -big).amax((1, 2))
    has_face = cond.any(2).any(1)

    xc = torch.floor((xs + xe) / 2)
    if use_openpose:
        yc = torch.floor((ys * 3 + ye * 2) / 5)
        ylen = torch.floor((xe - xs) * 2.5)
    else:
        yc = torch.floor((ys + ye) / 2)
        ylen = torch.floor((ye - ys) * 1.25)
    ylen = ylen.clamp(min=32.0).clamp(max=float(w))
    half = torch.floor(ylen / 2)
    yc = torch.minimum(torch.maximum(yc, half), (h - 1) - half)
    xc = torch.minimum(torch.maximum(xc, half), (w - 1) - half)

    yc = torch.where(has_face, yc, torch.tensor(float(h // 4), **f32))
    xc = torch.where(has_face, xc, torch.tensor(float(w // 2), **f32))
    ylen = torch.where(has_face, ylen, torch.tensor(float(h // 32 * 8), **f32))
    half = torch.floor(ylen / 2)
    boxes = torch.stack([yc - half, yc + half, xc - half, xc + half], 1)
    if crop_smaller:
        cs = float(crop_smaller)
        boxes = boxes + torch.tensor([cs, -cs, cs, -cs], **f32)
    return boxes


def crop_face_region(cfg: Config, image, input_label: torch.Tensor,
                     crop_smaller: int = 0, boxes=None):
    """The face box of `input_label`, cropped from the last three channels
    of `image` (B, H, W, C) and resized to face_size x face_size
    (face_refiner.py:33-40).  `image` may be a list, cropped with one box
    computation."""
    if boxes is None:
        boxes = get_face_boxes(cfg, input_label, crop_smaller)
    if isinstance(image, (list, tuple)):
        return [crop_face_region(cfg, im, input_label, crop_smaller, boxes)
                for im in image]
    fs = face_size_of(cfg)
    return crop_resize(image[..., -3:], boxes, (fs, fs))
