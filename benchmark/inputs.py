"""Seeded inputs shared by the drivers: label maps, images and motion,
made on the device from a torch.Generator.

  smooth(g, n, c, h, w, cells)  N(0, 1) on a (cells) grid, bilinear: maps
                                with structure at the grid's scale
  classes(g, n, h, w, k, cells) piecewise-constant maps of k classes on a
                                (cells) grid, nearest (segmentation)
  offset(t, motion)             frame t's horizontal offset in pixels:
                                shift_px a frame plus a sway of sway_px
                                over `period` frames
  moved(x, t, motion)           x (…, H, W, C) rolled by offset(t)
"""
from __future__ import annotations

import math


def smooth(torch, g, n: int, c: int, h: int, w: int, cells) -> "torch.Tensor":
    coarse = torch.randn(n, c, cells[0], cells[1], device=g.device, generator=g)
    up = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                         align_corners=False)
    return up.permute(0, 2, 3, 1).contiguous()          # (n, h, w, c)


def classes(torch, g, n: int, h: int, w: int, k: int, cells) -> "torch.Tensor":
    grid = torch.randint(k, (n, 1, cells[0], cells[1]), device=g.device, generator=g)
    up = torch.nn.functional.interpolate(grid.float(), size=(h, w), mode="nearest")
    return up.permute(0, 2, 3, 1).contiguous()          # (n, h, w, 1) class indices


def offset(t: int, motion: dict) -> int:
    sway = motion.get("sway_px", 0) * math.sin(2 * math.pi * t / motion.get("period", 1))
    return int(round(motion.get("shift_px", 0) * t + sway))


def moved(torch, x, t: int, motion: dict):
    return torch.roll(x, offset(t, motion), dims=-2)
