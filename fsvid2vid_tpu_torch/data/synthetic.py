"""Seeded synthetic datasets in the layouts the port's datasets read, for
smoke runs and tests.

`write_pose_dataset` writes the pose layout that FewshotPoseDataset reads
(no real DensePose or OpenPose output is needed):

  <root>/{train,test}_images/<seq>/<frame>.jpg
  <root>/{train,test}_openpose/<seq>/<frame>.json    BODY_25, face, hands
  <root>/{train,test}_densepose/<seq>/<frame>_IUV.png part index in blue
  <root>/{train,test}_densemask/<seq>/<frame>_INDS.png  person ids (inds)
  <root>/all_subsequences.json                        (subsequences)

Each frame shows a walking stick figure (body, 70 face points, two hands)
and a smaller second figure whose DensePose parts and mask id the INDS map
tells apart.  Frames move a few pixels from one to
the next, so flows between them are small.

`write_street_dataset` writes the street layout that FewshotStreetDataset
reads:

  <root>/{train,test}_labels/<seq>/<frame>.png   Cityscapes ids 0-33, "L"
  <root>/{train,test}_images/<seq>/<frame>.jpg

Each frame is a street scene of piecewise-constant regions (sky, buildings,
road, sidewalks, vegetation, a pole, cars, the ego vehicle) whose cars drive
a few pixels a frame, with an image painted from the regions' colours plus
noise.
"""
from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

# BODY_25 joints in a unit figure: x in [0, 1] across, y in [0, 1] down
_BODY = np.array([
    [0.50, 0.08], [0.50, 0.18], [0.38, 0.19], [0.32, 0.34], [0.30, 0.48],
    [0.62, 0.19], [0.68, 0.34], [0.70, 0.48], [0.50, 0.50], [0.42, 0.50],
    [0.41, 0.72], [0.40, 0.93], [0.58, 0.50], [0.59, 0.72], [0.60, 0.93],
    [0.47, 0.06], [0.53, 0.06], [0.44, 0.07], [0.56, 0.07], [0.64, 0.97],
    [0.66, 0.96], [0.59, 0.95], [0.36, 0.97], [0.34, 0.96], [0.41, 0.95]])
# DensePose part id of each limb (joint a, joint b, part)
_LIMBS = [(1, 8, 1), (2, 3, 15), (3, 4, 19), (5, 6, 16), (6, 7, 20),
          (9, 10, 9), (10, 11, 13), (12, 13, 10), (13, 14, 14),
          (11, 24, 5), (14, 21, 6), (2, 5, 2)]


def _face_points(center, scale):
    """70 face points (68 landmarks and 2 pupils) around `center`."""
    t = np.linspace(0.15 * np.pi, 0.85 * np.pi, 17)
    kp = np.zeros((70, 2))
    kp[:17] = np.stack([-np.cos(t), 0.2 + np.sin(t)], 1)
    kp[17:27] = np.stack([np.linspace(-0.7, 0.7, 10), np.full(10, -0.35)], 1)
    kp[27:36] = np.stack([np.r_[np.zeros(4), np.linspace(-0.2, 0.2, 5)],
                          np.r_[np.linspace(-0.2, 0.2, 4), np.full(5, 0.3)]], 1)
    ring = np.linspace(0, 2 * np.pi, 7)[:6]
    kp[36:42] = np.stack([-0.4 + 0.15 * np.cos(ring), -0.15 + 0.06 * np.sin(ring)], 1)
    kp[42:48] = np.stack([0.4 + 0.15 * np.cos(ring), -0.15 + 0.06 * np.sin(ring)], 1)
    m = np.linspace(0, 2 * np.pi, 21)[:20]
    kp[48:68] = np.stack([0.35 * np.cos(m), 0.55 + 0.1 * np.sin(m)], 1)
    kp[68:70] = [[-0.4, -0.15], [0.4, -0.15]]
    return center + kp * scale


def _hand_points(wrist, direction, scale):
    """21 hand points: the wrist and five fingers of four joints."""
    pts = [wrist]
    for f in range(5):
        ang = direction + (f - 2) * 0.3
        for j in range(1, 5):
            pts.append(wrist + scale * j * 0.25 * np.array([np.cos(ang), np.sin(ang)]))
    return np.array(pts)


def _person(rng, frame, h, w, x0, height):
    """Keypoint arrays of one figure at `frame`: body (25, 3), face (70, 3),
    hands (21, 3) x 2, confidences 0.9."""
    width = 0.5 * height
    body = np.stack([x0 + (_BODY[:, 0] - 0.5) * width + 2.0 * frame,
                     0.05 * h + _BODY[:, 1] * height], 1)
    body = body + rng.uniform(-1.5, 1.5, body.shape)
    face = _face_points(body[0], 0.05 * height)
    hands = [_hand_points(body[4], np.pi / 2, 0.08 * height),
             _hand_points(body[7], np.pi / 2, 0.08 * height)]
    conf = lambda p: np.concatenate([p, np.full((len(p), 1), 0.9)], 1)
    return conf(body), conf(face), [conf(p) for p in hands]


def _paint_densepose(iuv, inds, body, person_id, height):
    """Stamp the figure's DensePose parts (blue = part id, red / green = a
    UV ramp) and its INDS id along the limbs and as a head disc (parts 23
    and 24, split down the middle)."""
    h, w, _ = iuv.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    radius = 0.035 * height
    for a, b, part in _LIMBS:
        pa, pb = body[a, :2], body[b, :2]
        d = pb - pa
        t = np.clip(((xx - pa[0]) * d[0] + (yy - pa[1]) * d[1]) / max(d @ d, 1e-6), 0, 1)
        dist = np.hypot(xx - pa[0] - t * d[0], yy - pa[1] - t * d[1])
        on = dist < (2.5 if part in (1, 2) else 1.0) * radius
        iuv[on] = np.stack([40 + 200 * t[on], 40 + 200 * dist[on] / (2.5 * radius),
                            np.full(on.sum(), part)], 1).astype(np.uint8)
        inds[on] = person_id
    head = np.hypot(xx - body[0, 0], yy - body[0, 1]) < 0.07 * height
    iuv[head] = np.stack([np.full(head.sum(), 128), np.full(head.sum(), 128),
                          np.where(xx[head] < body[0, 0], 23, 24)], 1).astype(np.uint8)
    inds[head] = person_id


def write_pose_dataset(root: str, seed: int, n_seqs: int = 2, n_frames: int = 6,
                       size=(256, 192), inds: bool = True,
                       subsequences: bool = False) -> str:
    """Write the dataset under `root`; returns `root`.  size: (H, W) of the
    source frames.  With `subsequences`, all_subsequences.json splits each
    training sequence in two halves, each following one person (the
    per-frame person index is constant within a half, as a tracker writes
    it)."""
    rng = np.random.RandomState(seed)
    h, w = size
    splits = ("train", "test")
    for s in range(n_seqs):
        name = f"{s + 1:04d}"
        for split in splits:
            for kind in ("images", "openpose", "densepose") + (("densemask",) if inds else ()):
                os.makedirs(os.path.join(root, f"{split}_{kind}", name), exist_ok=True)
        height = rng.uniform(0.75, 0.85) * h
        x0 = rng.uniform(0.35, 0.45) * w
        for f in range(n_frames):
            people = [_person(rng, f, h, w, x0, height),
                      _person(rng, f, h, w, x0 + 0.35 * w, 0.5 * height)]
            iuv = np.zeros((h, w, 3), np.uint8)
            ids = np.zeros((h, w), np.uint8)
            for i, (body, _, _) in enumerate(people):
                _paint_densepose(iuv, ids, body, i + 1, height if i == 0 else 0.5 * height)
            small = rng.randint(0, 255, (h // 16, w // 16, 3), np.uint8)
            img = Image.fromarray(small).resize((w, h), Image.BICUBIC)
            img = Image.fromarray(np.where(ids[..., None] > 0, 255 - iuv, np.asarray(img)))
            payload = {"people": [{
                "pose_keypoints_2d": body.reshape(-1).tolist(),
                "face_keypoints_2d": face.reshape(-1).tolist(),
                "hand_left_keypoints_2d": hands[0].reshape(-1).tolist(),
                "hand_right_keypoints_2d": hands[1].reshape(-1).tolist()}
                for body, face, hands in people]}
            for split in splits:
                base = lambda kind: os.path.join(root, f"{split}_{kind}", name)
                img.save(os.path.join(base("images"), f"{f:05d}.jpg"), quality=90)
                with open(os.path.join(base("openpose"), f"{f:05d}.json"), "w") as fp:
                    json.dump(payload, fp)
                Image.fromarray(iuv).save(os.path.join(base("densepose"), f"{f:05d}_IUV.png"))
                if inds:
                    Image.fromarray(ids).save(os.path.join(base("densemask"),
                                                           f"{f:05d}_INDS.png"))
    if subsequences:
        half = n_frames // 2
        sub = {"seq_indices": [], "start_frame_indices": [], "end_frame_indices": [],
               "ppl_indices": []}
        for s in range(n_seqs):
            for start, end in ((0, half), (half, n_frames)):
                sub["seq_indices"].append(s)
                sub["start_frame_indices"].append(start)
                sub["end_frame_indices"].append(end)
                sub["ppl_indices"].append([int(rng.randint(2))] * (end - start))
        with open(os.path.join(root, "all_subsequences.json"), "w") as fp:
            json.dump(sub, fp)
    return root


# Cityscapes ids of the street scene's regions (the 35-class label maps the
# street dataset remaps to 20), and each region's colour in the frames
_STREET_COLOURS = {1: (20, 20, 20), 7: (128, 64, 128), 8: (244, 35, 232),
                   11: (70, 70, 70), 17: (153, 153, 153), 21: (107, 142, 35),
                   23: (70, 130, 180), 26: (0, 0, 142)}


def _street_ids(rng, h, w, frame, cars, buildings):
    """(h, w) uint8 Cityscapes ids of one frame."""
    yy, xx = np.mgrid[0:h, 0:w]
    horizon = 0.45 * h
    ids = np.full((h, w), 23, np.uint8)                         # sky
    for x0, x1, top in buildings:
        ids[(xx >= x0 * w) & (xx < x1 * w) & (yy >= top * h) & (yy < horizon)] = 11
    ids[(yy >= horizon - 0.08 * h) & (yy < horizon) & (xx < 0.2 * w)] = 21  # trees
    ground = yy >= horizon
    ids[ground] = 8                                             # sidewalks
    spread = (yy - horizon) * (w / h) * 0.9
    ids[ground & (np.abs(xx - w / 2) < 0.08 * w + spread)] = 7  # road
    ids[(np.abs(xx - 0.82 * w) < 0.006 * w) & (yy > 0.2 * h) & (yy < 0.7 * h)] = 17
    for x, y, size, speed in cars:
        cx = (x + speed * frame) % 1.0 * w
        ids[(np.abs(xx - cx) < size * w) & (yy > y * h - 0.6 * size * w)
            & (yy < y * h)] = 26
    ids[yy >= 0.92 * h] = 1                                     # ego vehicle
    return ids


def write_street_dataset(root: str, seed: int, n_seqs: int = 2, n_frames: int = 6,
                         size=(512, 1024)) -> str:
    """Write the dataset under `root`; returns `root`.  size: (H, W) of the
    source frames; 512 x 1024 makes the street preset's random scale and
    crop to 256 x 512 rescale every frame."""
    rng = np.random.RandomState(seed)
    h, w = size
    for s in range(n_seqs):
        name = f"{s + 1:04d}"
        for split in ("train", "test"):
            for kind in ("labels", "images"):
                os.makedirs(os.path.join(root, f"{split}_{kind}", name), exist_ok=True)
        buildings = [(x0, x0 + rng.uniform(0.1, 0.2), rng.uniform(0.05, 0.3))
                     for x0 in np.arange(0.0, 1.0, 0.22)]
        cars = [(rng.uniform(0, 1), rng.uniform(0.6, 0.85), rng.uniform(0.03, 0.06),
                 rng.choice([-1, 1]) * rng.uniform(0.004, 0.01)) for _ in range(3)]
        tint = rng.uniform(0.8, 1.2, 3)
        for f in range(n_frames):
            ids = _street_ids(rng, h, w, f, cars, buildings)
            palette = np.zeros((256, 3))
            for cid, colour in _STREET_COLOURS.items():
                palette[cid] = np.asarray(colour) * tint
            texture = Image.fromarray(rng.randint(0, 255, (h // 32, w // 32, 3), np.uint8))
            texture = np.asarray(texture.resize((w, h), Image.BICUBIC), np.float64)
            pixels = palette[ids] + 0.15 * (texture - 128) + rng.normal(0, 4, (h, w, 3))
            img = Image.fromarray(np.clip(pixels, 0, 255).astype(np.uint8))
            label = Image.fromarray(ids)   # uint8 (h, w): mode "L"
            for split in ("train", "test"):
                label.save(os.path.join(root, f"{split}_labels", name, f"{f:05d}.png"))
                img.save(os.path.join(root, f"{split}_images", name, f"{f:05d}.jpg"),
                         quality=90)
    return root
