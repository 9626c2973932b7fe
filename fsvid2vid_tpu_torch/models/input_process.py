"""Label pre-processing at inference (port of
fsvid2vid_tpu/models/input_process.py:66-91, reference input_process.py).

Channel-last like the pipeline's public layout.  For face and street
configurations `use_valid_labels` is the identity.
"""
from __future__ import annotations

import torch

from fsvid2vid_tpu_torch.config import Config

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
