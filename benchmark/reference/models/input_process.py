# The benchmark's frozen copy of fsvid2vid_tpu_torch/models/input_process.py, its imports
# pointed at this package: it imports nothing of the port.
"""Label pre-processing and mask derivation (port of
fsvid2vid_tpu/models/input_process.py, reference input_process.py).

Channel-last like the public layout of the pipeline and of the train step.
Street labels (label_nc > 0) arrive as (..., H, W, 1) class indices and are
one-hot encoded on the device (`encode_label`) wherever a label enters the
model.  For face and street configurations `use_valid_labels` is the
identity and there is no foreground mask.  Pose labels carry the DensePose
part index in channel 2, scaled to [-1, 1]; the body-part and face masks
derive from it.
"""
from __future__ import annotations

import torch

from benchmark.reference.config import Config
from benchmark.reference.ops.image_ops import avg_pool, max_pool

# DensePose's 25 part ids grouped into 9 body parts (input_process.py:65)
PART_GROUPS = [[0], [1, 2], [3, 4], [5, 6], [7, 9, 8, 10], [11, 13, 12, 14],
               [15, 17, 16, 18], [19, 21, 20, 22], [23, 24]]
FACE_PART_IDS = (23, 24)   # DensePose face parts


def _part_is(part: torch.Tensor, ids) -> torch.Tensor:
    m = torch.zeros(part.shape, dtype=torch.bool, device=part.device)
    for j in ids:
        m = m | ((part > j - 0.1) & (part < j + 0.1))
    return m


def get_face_mask(pose: torch.Tensor) -> torch.Tensor:
    """Face mask from a DensePose part channel, (..., H, W) -> float."""
    return _part_is((pose / 2 + 0.5) * 24, FACE_PART_IDS).float()


def get_part_mask(pose: torch.Tensor) -> torch.Tensor:
    """9 body-part masks from a DensePose part channel (reference
    input_process.py:64-80): (..., H, W) -> (..., H, W, 9) float."""
    part = (pose / 2 + 0.5) * 24
    return torch.stack([_part_is(part, g) for g in PART_GROUPS], -1).float()


def smoothed_face_mask(pose: torch.Tensor) -> torch.Tensor:
    """The face mask blurred by a 15 x 15 average pool whose zero padding
    counts (reference loss_collector.py:177-178): (B, H, W) -> (B, H, W, 1)."""
    face = get_face_mask(pose)[:, None]
    return avg_pool(face, 15, 1, 7).permute(0, 2, 3, 1)


def encode_label(cfg: Config, label: torch.Tensor) -> torch.Tensor:
    """One-hot encode class-index label maps when label_nc > 0, else return
    the label as it is (JAX input_process.py:24 `encode_label`; reference
    input_process.py:25-45 `encode_input`).  (..., H, W, 1) indices ->
    (..., H, W, label_nc) f32, the rows of an identity matrix as in the JAX
    function, so the two agree bit for bit."""
    if cfg.label_nc == 0:
        return label
    idx = label[..., 0].long()
    return torch.eye(cfg.label_nc, dtype=torch.float32, device=label.device)[idx]


def use_valid_labels(cfg: Config, pose):
    """Strip the DensePose channels ('open' pose type) or blank the face
    region (remove_face_labels).  (B, H, W, C) or (B, K, H, W, C)."""
    if not cfg.is_pose or pose is None:
        return pose
    if cfg.pose_type == "open":
        return pose[..., 3:]
    if cfg.remove_face_labels:
        face = get_face_mask(pose[..., 2])[..., None]
        dp = pose[..., :3] * (1 - face) - face
        return torch.cat([dp, pose[..., 3:]], -1)
    return pose


def get_fg_mask(cfg: Config, label: torch.Tensor):
    """Foreground (human) mask for pose, dilated by a 15 x 15 max pool
    (reference input_process.py:52-61); None where the configuration has no
    foreground.  label: (B, H, W, C) -> (B, H, W, 1)."""
    if not cfg.has_fg:
        return None
    mask = label[..., 2:3] if cfg.label_nc == 0 else -label[..., 0:1]
    mask = max_pool(mask.permute(0, 3, 1, 2), 15, 1, 7).permute(0, 2, 3, 1)
    return (mask > -1).float()


def combine_fg_mask(fg_mask, ref_fg_mask, has_fg: bool):
    """Union of the target's and the reference's foreground masks; 1.0 where
    the configuration has no foreground."""
    if not has_fg:
        return 1.0
    return ((fg_mask > 0) | (ref_fg_mask > 0)).float()
