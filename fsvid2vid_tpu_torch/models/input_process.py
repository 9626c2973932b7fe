"""Label pre-processing and mask derivation (port of
fsvid2vid_tpu/models/input_process.py, reference input_process.py).

Channel-last like the public layout of the pipeline and of the train step.
For face and street configurations `use_valid_labels` is the identity and
there is no foreground mask.
"""
from __future__ import annotations

import torch

from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.ops.image_ops import max_pool

FACE_PART_IDS = (23, 24)   # DensePose face parts


def get_face_mask(pose: torch.Tensor) -> torch.Tensor:
    """Face mask from a DensePose part channel, (..., H, W) -> float."""
    part = (pose / 2 + 0.5) * 24
    m = torch.zeros(pose.shape, dtype=torch.bool, device=pose.device)
    for j in FACE_PART_IDS:
        m = m | ((part > j - 0.1) & (part < j + 0.1))
    return m.float()


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
