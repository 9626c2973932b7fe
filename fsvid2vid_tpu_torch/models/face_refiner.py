"""Face boxes, face crops and face refinement of pose frames (port of
fsvid2vid_tpu/models/face_refiner.py; reference models/face_refiner.py).

The reference finds each sample's face box with `.nonzero()` and Python
ints (face_refiner.py:54-86); here, as in the JAX package, the box comes
from masked min / max reductions and the crop and the paste are fixed-shape
bilinear samples (ops/crop.py), so boxes, crops and pastes stay on the
device.  Channel-last, as the JAX functions; the face generator netGf
(`FewShotGenerator(..., for_face=True)`) takes the crops as channels-last
views of (B, C, h, w) in `refine_face_region`.
"""
from __future__ import annotations

import torch

from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.ops.crop import crop_resize, paste_region


def face_size_of(cfg: Config) -> int:
    """Side of the square face crop (face_refiner.py:21)."""
    return int(cfg.fine_size / cfg.aspect_ratio) // 4


def face_refiner_config(cfg: Config) -> Config:
    """The face generator's configuration (JAX training/state.py:56-66,
    reference base_model.py:175-181): one downsampling and one adaptive
    layer fewer, 3-channel labels (the crop's last three channels), square
    face_size crops."""
    fs = face_size_of(cfg)
    return cfg.replace(
        n_downsample_G=cfg.n_downsample_G - 1,
        n_adaptive_layers=(cfg.n_adaptive_layers - 1 if cfg.n_adaptive_layers > 0
                           else cfg.n_adaptive_layers),
        input_nc=cfg.output_nc, fine_size=fs, load_size=fs, aspect_ratio=1.0)


def check_refine_face(cfg: Config) -> None:
    """Face refinement runs at n_shot 1 and without adaptive_conv only, as
    far as the JAX package runs it, and the port does not add what the JAX
    package lacks (ROADMAP.md C): its refiner keeps n_shot in its config but
    is handed one reference, and it keeps adaptive_conv, whose blocks
    `forward_face` hands no conv weights."""
    if not cfg.refine_face:
        return
    if cfg.n_shot > 1:
        raise NotImplementedError(
            f"refine_face at n_shot {cfg.n_shot}: the JAX package's face refiner runs "
            "at n_shot 1 only (face_refiner_config keeps n_shot, refine_face_region "
            "passes one reference; its init fails with TypeError: cannot reshape "
            "array; ROADMAP.md C)")
    if cfg.adaptive_conv:
        raise NotImplementedError(
            "refine_face with adaptive_conv: the JAX package's face refiner fails "
            "there (face_refiner_config keeps adaptive_conv, forward_face passes None "
            "conv weights to its conv_params_free blocks; its init fails with "
            "TypeError: 'NoneType' object is not subscriptable; ROADMAP.md C)")


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


def replace_face_region(cfg: Config, fake_image, fake_face, input_label,
                        fake_face_coarse=None, crop_smaller: int = 0, boxes=None):
    """The refined face (the residual `fake_face` added to the coarse crop),
    clamped to [-1, 1] and pasted into the face box of `fake_image`
    (face_refiner.py:43-51)."""
    if boxes is None:
        boxes = get_face_boxes(cfg, input_label, crop_smaller)
    face = fake_face if fake_face_coarse is None else fake_face + fake_face_coarse
    return paste_region(fake_image, face.clamp(-1.0, 1.0), boxes)


def refine_face_region(cfg: Config, netGf, label_valid, fake_image, label,
                       ref_label_valid, ref_image, ref_label):
    """Crop the target's and the picked reference's faces, run the face
    generator `netGf` on the coarse face, paste the result back
    (face_refiner.py:24-29).  Labels and images (B, H, W, C); the coarse face
    is detached, as the JAX stop_gradient, so G's gradient reaches the
    refined frame only outside the face box."""
    boxes = get_face_boxes(cfg, label, crop_smaller=4)
    label_face, coarse_face = crop_face_region(
        cfg, [label_valid, fake_image], label, crop_smaller=4, boxes=boxes)
    ref_label_face, ref_img_face = crop_face_region(
        cfg, [ref_label_valid, ref_image], ref_label, crop_smaller=4)
    coarse_face = coarse_face.detach()
    nchw = lambda x: x.movedim(-1, -3)
    fake_face = netGf.forward_face(nchw(label_face), nchw(ref_label_face)[:, None],
                                   nchw(ref_img_face)[:, None], nchw(coarse_face))
    return replace_face_region(cfg, fake_image, fake_face.movedim(-3, -1), label,
                               coarse_face, crop_smaller=4, boxes=boxes)
