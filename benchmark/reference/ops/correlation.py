"""FlowNetC's correlation cost volume in plain PyTorch (the port's
`cost_volume_plain`, fsvid2vid_tpu_torch/ops/cost_volume.py, copied; kernel
B2's plain version).  With d = max_displacement // stride, D = 2 d + 1:

  out[b, k, y, x] = (1/C) * sum_c f1[b, c, y, x] * f2[b, c, y + dy, x + dx]
  k = dy_idx * D + dx_idx, f2 read as zero outside the map

The flow teacher is frozen, so no gradient is taken through it."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def displacements(max_displacement: int, stride: int):
    """[(dy, dx)] in output-channel order (dy-major)."""
    d = max_displacement // stride
    return [(dy * stride, dx * stride)
            for dy in range(-d, d + 1) for dx in range(-d, d + 1)]


def correlation(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20,
                stride: int = 2) -> torch.Tensor:
    """One multiply-and-reduce over channels per displacement against a
    zero-padded f2, accumulated in f32; output in the input dtype."""
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"correlation: f1 {tuple(f1.shape)}, f2 {tuple(f2.shape)}")
    b, c, h, w = f1.shape
    md = max_displacement
    f1_32 = f1.float()
    f2p = F.pad(f2.float(), (md, md, md, md))
    outs = [(f1_32 * f2p[:, :, md + dy:md + dy + h, md + dx:md + dx + w]).sum(1)
            for dy, dx in displacements(md, stride)]
    return (torch.stack(outs, 1) * (1.0 / c)).to(f1.dtype)
