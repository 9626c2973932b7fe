"""Array -> displayable-image converters (the port's copy of
fsvid2vid_tpu/utils/imaging.py; reference util/util.py:43-106, 179-206),
numpy/NHWC; cv2-free HSV flow visualization."""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def _last_frame(arr: np.ndarray) -> np.ndarray:
    """Reduce (T,B,...)/(B,...) stacks to one HWC frame (util.py:51-58)."""
    while arr.ndim > 3:
        arr = arr[-1]
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def tensor2im(arr, normalize: bool = True, tile: bool = False):
    """NHWC [-1,1] (or [0,1] when normalize=False) -> uint8 HWC RGB."""
    if arr is None:
        return None
    if isinstance(arr, (list, tuple)):
        imgs = [tensor2im(a, normalize) for a in arr if a is not None]
        if not imgs:
            return None
        return tile_images(imgs) if tile else imgs
    arr = np.asarray(arr, np.float32)
    if tile and arr.ndim == 4:
        return tile_images([tensor2im(arr[b], normalize)
                            for b in range(arr.shape[0])])
    arr = _last_frame(arr)
    out = (arr + 1) / 2.0 * 255.0 if normalize else arr * 255.0
    out = np.clip(out, 0, 255)
    if out.shape[-1] == 1:
        out = np.repeat(out, 3, axis=-1)
    return out.astype(np.uint8)


def tensor2label(arr, n_label: int) -> Optional[np.ndarray]:
    """One-hot or index label map (HWC) -> colorized uint8 RGB."""
    if arr is None:
        return None
    arr = _last_frame(np.asarray(arr, np.float32))
    if arr.shape[-1] > 1:
        idx = arr.argmax(-1)
    else:
        idx = arr[..., 0].astype(np.int64)
    cmap = labelcolormap(n_label)
    return cmap[np.clip(idx, 0, n_label - 1)]


def tensor2flow(arr) -> Optional[np.ndarray]:
    """(H,W,2) pixel flow -> HSV-coded uint8 RGB (util.py:82-106)."""
    if arr is None:
        return None
    if isinstance(arr, (list, tuple)):
        imgs = [tensor2flow(a) for a in arr if a is not None]
        return imgs or None
    arr = np.asarray(arr, np.float32)
    while arr.ndim > 3:
        arr = arr[-1]
    u, v = arr[..., 0], arr[..., 1]
    mag = np.sqrt(u * u + v * v)
    ang = np.arctan2(v, u) % (2 * np.pi)
    hue = ang * 180 / np.pi / 2 / 179.0          # cv2 H range 0..179
    mmax = mag.max()
    val = mag / mmax if mmax > 0 else mag
    sat = np.ones_like(hue)
    return (_hsv_to_rgb(hue, sat, val) * 255).astype(np.uint8)


def _hsv_to_rgb(h, s, v):
    i = np.floor(h * 6.0).astype(int) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    choices = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    r = np.choose(i, [c[0] for c in choices])
    g = np.choose(i, [c[1] for c in choices])
    b = np.choose(i, [c[2] for c in choices])
    return np.stack([r, g, b], -1)


def tile_images(imgs: List[np.ndarray], picturesPerRow: int = 4) -> np.ndarray:
    """Grid layout (util.py tile_images)."""
    n = len(imgs)
    if n == 1:
        return imgs[0]
    per_row = min(picturesPerRow, n)
    rows = []
    for i in range(0, n, per_row):
        row = imgs[i:i + per_row]
        while len(row) < per_row:
            row.append(np.zeros_like(row[0]))
        rows.append(np.concatenate(row, axis=1))
    return np.concatenate(rows, axis=0)


def uint82bin(n, count=8):
    return "".join([str((n >> y) & 1) for y in range(count - 1, -1, -1)])


def labelcolormap(n: int) -> np.ndarray:
    """Cityscapes 35/20-class palettes or bit-twiddled fallback
    (util.py:179-206)."""
    if n == 35:
        return np.array(
            [(0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0),
             (111, 74, 0), (81, 0, 81), (128, 64, 128), (244, 35, 232),
             (250, 170, 160), (230, 150, 140), (70, 70, 70), (102, 102, 156),
             (190, 153, 153), (180, 165, 180), (150, 100, 100),
             (150, 120, 90), (153, 153, 153), (153, 153, 153), (250, 170, 30),
             (220, 220, 0), (107, 142, 35), (152, 251, 152), (70, 130, 180),
             (220, 20, 60), (255, 0, 0), (0, 0, 142), (0, 0, 70),
             (0, 60, 100), (0, 0, 90), (0, 0, 110), (0, 80, 100),
             (0, 0, 230), (119, 11, 32), (0, 0, 142)], dtype=np.uint8)
    if n == 20:
        return np.array(
            [(128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
             (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
             (107, 142, 35), (152, 251, 152), (220, 20, 60), (255, 0, 0),
             (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 80, 100), (0, 0, 230),
             (119, 11, 32), (70, 130, 180), (0, 0, 0)], dtype=np.uint8)
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        idx = i + 1
        for j in range(7):
            sid = uint82bin(idx)
            r = r ^ (np.uint8(sid[-1]) << (7 - j))
            g = g ^ (np.uint8(sid[-2]) << (7 - j))
            b = b ^ (np.uint8(sid[-3]) << (7 - j))
            idx = idx >> 3
        cmap[i] = (r, g, b)
    return cmap


def save_image(arr: np.ndarray, path: str) -> None:
    from PIL import Image
    Image.fromarray(arr).save(path)
