"""Pose training traffic: temporal training through the port's
`Trainer.train_epoch` on DensePose + OpenPose label maps, with whatever the
configuration adds for pose (the face discriminator, remat, face
refinement).  The window, the feed, the recorder, the traced segment, the
FLOP count, the reference's steps and the comparison are training's
(benchmark/drivers/train.py, reused by import); this file brings the label
maps and the compared numbers of the face networks.

Labels (`labels`: {"kind": "figures", "figures": F, "sway_px": s}), painted
on the device from (seed, sequence index) with vectorised torch operations
(distances to the limb segments), in the 6-channel encoding of the port's
pose dataset:

  channels 0-1  DensePose U / V ramps in [-1, 1] (along and across a limb)
  channel 2     the DensePose part id p as p / 24 x 2 - 1, exactly on those
                levels: 12 limbs, two hands (parts 3, 4) and a head disc
                split down the middle into parts 23 and 24
  channels 3-5  the OpenPose render in [-1, 1]: each limb and the neck as a
                line of its own colour
  background    -1 in every channel

Each sample shows F figures, as the port's synthetic pose set paints them
(one 75-85 % of the frame tall, the others half that, beside it).  Every
figure is in the OpenPose render; the DensePose channels hold the first
figure alone, as the pose dataset delivers them after it removes the other
people's DensePose through the INDS maps.  So the face box, the face mask,
the foreground and all nine body-part groups are the first figure's.
Each sample's target follows one of its references, the figures moving by
`sway_px` a frame (left or right, drawn per sample), its image the
reference's image rolled by the same offset.
"""
from __future__ import annotations

import contextlib
import statistics
from typing import Dict
from unittest import mock

from benchmark import inputs
from benchmark.drivers import train
from benchmark.seeds import subseed

# joints of a unit figure (x across, y down, in [0, 1]): nose, neck,
# right shoulder / elbow / wrist, left shoulder / elbow / wrist, mid hip,
# right hip / knee / ankle, left hip / knee / ankle, right / left toe
JOINTS = [(0.50, 0.08), (0.50, 0.18), (0.38, 0.19), (0.32, 0.34), (0.30, 0.48),
          (0.62, 0.19), (0.68, 0.34), (0.70, 0.48), (0.50, 0.50), (0.42, 0.50),
          (0.41, 0.72), (0.40, 0.93), (0.58, 0.50), (0.59, 0.72), (0.60, 0.93),
          (0.36, 0.97), (0.64, 0.97)]
# (joint a, joint b, DensePose part, half-width in units of the radius)
LIMBS = [(1, 8, 1, 2.5), (2, 5, 2, 2.5), (2, 3, 15, 1.0), (3, 4, 19, 1.0),
         (5, 6, 16, 1.0), (6, 7, 20, 1.0), (9, 10, 9, 1.0), (10, 11, 13, 1.0),
         (12, 13, 10, 1.0), (13, 14, 14, 1.0), (11, 15, 5, 1.0), (14, 16, 6, 1.0)]
HANDS = [(4, 3), (7, 4)]          # (wrist joint, DensePose part)
HEAD_PARTS = (23, 24)             # left and right of the nose
RADIUS = 0.035                    # a limb's radius, of the figure's height
HEAD_RADIUS = 0.07
HAND_RADIUS = 0.03
# OpenPose lines: the limbs, then the neck; one colour each, in [-1, 1]
OPENPOSE_LINES = [(a, b) for a, b, _, _ in LIMBS] + [(0, 1)]
OPENPOSE_COLOURS = [(1.0, -1.0, -0.33), (1.0, 0.33, -1.0), (1.0, 1.0, -1.0),
                    (0.33, 1.0, -1.0), (-0.33, 1.0, -1.0), (-1.0, 1.0, -0.33),
                    (-1.0, 1.0, 0.33), (-1.0, 1.0, 1.0), (-1.0, 0.33, 1.0),
                    (-1.0, -0.33, 1.0), (-0.33, -1.0, 1.0), (0.33, -1.0, 1.0),
                    (1.0, -1.0, 1.0)]
OPENPOSE_WIDTH = 0.01             # a line's half-width, of the figure's height


def part_level(p: int) -> float:
    return p / 24 * 2 - 1


def _segment(torch, yy, xx, pa, pb):
    """Per frame, each pixel's position along segment pa -> pb (clamped to
    [0, 1]) and its distance to the segment; pa, pb (N, 2) as (x, y)."""
    ax, ay = pa[:, 0, None, None], pa[:, 1, None, None]
    dx, dy = (pb[:, 0] - pa[:, 0])[:, None, None], (pb[:, 1] - pa[:, 1])[:, None, None]
    along = ((xx - ax) * dx + (yy - ay) * dy) / (dx * dx + dy * dy).clamp(min=1e-6)
    along = along.clamp(0.0, 1.0)
    dist = torch.hypot(xx - ax - along * dx, yy - ay - along * dy)
    return along, dist


def paint(torch, joints, heights, h: int, w: int):
    """Label maps (N, h, w, 6) of N frames from the figures' joints (N, F,
    J, 2) in pixels (x, y) and heights (N, F); figure 0 alone in the
    DensePose channels.  Nothing is read back to the host or copied to the
    device, so the painting runs as fast as its kernels launch."""
    n, figures = joints.shape[:2]
    dev = joints.device
    yy = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    out = torch.full((n, h, w, 6), -1.0, device=dev)
    dp = out[..., :3]
    body, height = joints[:, 0], heights[:, 0, None, None]
    radius = RADIUS * height

    def densepose(on, u, v, part):
        """dp where `on` holds: (u, v, the level of `part`)."""
        value = torch.stack([u, v, torch.full_like(u, part_level(part))], -1)
        dp.copy_(torch.where(on[..., None], value, dp))

    for a, b, part, widen in LIMBS:
        along, dist = _segment(torch, yy, xx, body[:, a], body[:, b])
        densepose(dist < widen * radius, (along * 200 + 40) / 127.5 - 1,
                  (dist / (2.5 * radius) * 200 + 40) / 127.5 - 1, part)
    for joint, part in HANDS:
        _, dist = _segment(torch, yy, xx, body[:, joint], body[:, joint])
        zero = torch.zeros_like(dist)
        densepose(dist < HAND_RADIUS * height, zero, zero, part)
    _, dist = _segment(torch, yy, xx, body[:, 0], body[:, 0])
    zero = torch.zeros_like(dist)
    left = (xx < body[:, 0, 0, None, None]).expand_as(dist)
    on = dist < HEAD_RADIUS * height
    densepose(on & left, zero, zero, HEAD_PARTS[0])
    densepose(on & ~left, zero, zero, HEAD_PARTS[1])
    op = out[..., 3:]
    for f in range(figures):
        width = (OPENPOSE_WIDTH * heights[:, f, None, None]).clamp(min=1.5)
        for (a, b), colour in zip(OPENPOSE_LINES, OPENPOSE_COLOURS):
            _, dist = _segment(torch, yy, xx, joints[:, f, a], joints[:, f, b])
            value = torch.stack([torch.full_like(dist, c) for c in colour], -1)
            op.copy_(torch.where((dist < width)[..., None], value, op))
    return out


class FigureSequences(train.Sequences):
    """Sequence i's batch: the figures' label maps and smooth images, made
    on the device from (seed, i)."""

    def __init__(self, torch, cfg, traffic: dict, seed: int, device):
        super().__init__(torch, cfg, traffic, seed, device)
        self.unit = torch.tensor(JOINTS, device=device)

    def make(self, i: int) -> Dict:
        torch, spec = self.torch, self.traffic["labels"]
        if spec["kind"] != "figures":
            raise ValueError(f"labels kind {spec['kind']!r}: this driver paints figures")
        dev = self.device
        g = torch.Generator(device=dev).manual_seed(subseed(self.seed, "sequence", i))
        b, k, h, w, t, f = self.b, self.k, self.h, self.w, self.t, spec["figures"]
        fav = torch.randint(k, (b,), device=dev, generator=g)
        rows = torch.arange(b, device=dev)
        uni = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(*shape, device=dev, generator=g)
        # per reference: the first figure's height and place, the others
        # half as tall, side by side; each joint jittered by up to 1.5 px
        tall = uni(0.75, 0.85, b, k) * h
        heights = torch.stack([tall] + [tall / 2] * (f - 1), -1)            # (b, k, f)
        x0 = uni(0.35, 0.45, b, k)[..., None] * w + 0.35 * w * torch.arange(f, device=dev)
        unit = self.unit                                                     # (J, 2)
        joints = torch.stack([
            x0[..., None] + (unit[:, 0] - 0.5) * 0.5 * heights[..., None],
            0.05 * h + unit[:, 1] * heights[..., None]], -1)                # (b, k, f, J, 2)
        joints = joints + uni(-1.5, 1.5, *joints.shape)
        sway = (torch.randint(2, (b,), device=dev, generator=g) * 2 - 1) * spec["sway_px"]
        ref_labels = paint(torch, joints.flatten(0, 1), heights.flatten(0, 1), h, w)
        ref_labels = ref_labels.view(b, k, h, w, 6)
        steps = torch.arange(t, device=dev, dtype=torch.float32)
        shift = sway[:, None].float() * steps                                # (b, t)
        moved = joints[rows, fav][:, None].repeat(1, t, 1, 1, 1)    # (b, t, f, J, 2)
        moved[..., 0] += shift[..., None, None]
        tgt_label = paint(torch, moved.flatten(0, 1),
                          heights[rows, fav][:, None].expand(b, t, f).flatten(0, 1), h, w)
        ref_images = torch.tanh(inputs.smooth(torch, g, b * k, 3, h, w,
                                              self.traffic["image_cells"])).view(b, k, h, w, 3)
        # frame j: the reference's image rolled by shift[s, j] along x,
        # column x taking column x - shift (mod w)
        cols = (torch.arange(w, device=dev) - shift.long()[..., None]) % w     # (b, t, w)
        tgt_image = ref_images[rows, fav][:, None].expand(b, t, h, w, 3).gather(
            3, cols[:, :, None, :, None].expand(b, t, h, w, 3))
        return {"tgt_label": tgt_label.view(b, t, h, w, 6).contiguous(),
                "tgt_image": tgt_image.contiguous(),
                "ref_labels": ref_labels, "ref_images": ref_images}


# ----------------------------------------------------------------------
# the compared numbers of the face networks
# ----------------------------------------------------------------------
FACE_NETS = ("Gf", "Df")
_training_compare = train.compare


def compare(side: Dict, ref: Dict) -> Dict[str, float]:
    """training's numbers (train.compare, which counts netGf's leaves in G's
    and netDf's in D's), and direction_gap.Gf / .Df: the step-1 update
    direction of the face generator's and the face discriminator's leaves
    alone, over the leaves train.compare's directions take (absent where
    the configuration has no such network)."""
    out = _training_compare(side, ref)
    present = [net for net in FACE_NETS
               if any(train._net(n) == net for n in ref["grads"])]
    if not present:
        return out
    if min(len(side["losses"]), len(ref["losses"])) < train.CHECKED_STEPS:
        return dict(out, **{f"direction_gap.{net}": float("inf") for net in present})
    g_floor = statistics.median(ref["grads"].values())
    moving = [n for n, rv in ref["grads"].items() if rv >= train.STILL_LEAF * g_floor]
    for net in present:
        mine = [n for n in moving if train._net(n) == net]
        out[f"direction_gap.{net}"] = train._direction_gap(
            [side["first_updates"].get(n) for n in mine],
            [ref["first_updates"][n] for n in mine])
    return out


def recomputes():
    """The port's count of remat re-runs, or None where it keeps none."""
    try:
        from fsvid2vid_tpu_torch.models.remat import remat
    except ImportError:
        return None
    return getattr(remat, "recomputes", None)


@contextlib.contextmanager
def figures(run):
    """training's driver with this traffic's sequences and compared numbers;
    its traced segment also prints the remat re-runs per train step."""
    segment = train.traced_segment

    def traced(run_, trainer, teacher, seqs, epoch, index):
        before = recomputes()
        summary = segment(run_, trainer, teacher, seqs, epoch, index)
        after = recomputes()
        if before is not None and after is not None:
            run.log(f"recomputes_per_step {(after - before) / seqs.t}")
        return summary

    with mock.patch.object(train, "Sequences", FigureSequences), \
            mock.patch.object(train, "compare", compare), \
            mock.patch.object(train, "traced_segment", traced):
        yield


def execute(run):
    with figures(run):
        return train.execute(run)


def control(run, fp8: bool = True) -> Dict[str, Dict[str, float]]:
    with figures(run):
        return train.control(run, fp8)

