"""PyTorch / CUDA port of fsvid2vid_tpu for NVIDIA Hopper GPUs.

Module names mirror the JAX package (fsvid2vid_tpu), which stays the
reference.  Modules run NCHW inside; the public functions that the tests
compare with the JAX package keep its layouts (flash_ref_attention takes
(B, hw, c); the inference pipeline takes and returns NHWC frames).

Entry points run on CUDA unless the caller passes device="cpu".
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else CUDA.

    Raises when no device is given and no CUDA device is present, so a run
    meant for the card never carries on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
