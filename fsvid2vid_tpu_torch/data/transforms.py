"""Host-side image transforms and video sampling parameters (the port's copy
of fsvid2vid_tpu/data/transforms.py; reference data/base_dataset.py:62-170),
numpy/PIL only, with explicit np.random.RandomState instead of the global
`random` module (deterministic, worker-safe)."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from PIL import Image

from fsvid2vid_tpu_torch.config import Config


def get_img_params(cfg: Config, size: Tuple[int, int],
                   rng: np.random.RandomState) -> Dict:
    """Resize/crop/flip/color-aug parameters (base_dataset.py:62-99).
    size = (w, h) target."""
    w, h = size
    new_w, new_h = w, h
    roc = cfg.resize_or_crop
    if "resize" in roc:
        new_h = new_w = cfg.load_size
    else:
        if "scale_width" in roc:
            new_w = cfg.load_size
        elif "random_scale" in roc:
            new_w = rng.randint(int(cfg.fine_size), int(1.2 * cfg.fine_size))
        new_h = int(new_w * h) // w
    if "crop" not in roc:
        new_h = int(new_w // cfg.aspect_ratio)
    new_w = new_w // 4 * 4
    new_h = new_h // 4 * 4

    size_x = min(cfg.load_size, cfg.fine_size)
    size_y = int(size_x // cfg.aspect_ratio)
    if not cfg.is_train:
        pos_x = (new_w - size_x) // 2
        pos_y = (new_h - size_y) // 2
    else:
        pos_x = rng.randint(max(1, new_w - size_x))
        pos_y = rng.randint(max(1, new_h - size_y))

    color_aug = (rng.uniform(-30, 30), rng.uniform(0.8, 1.2),
                 rng.uniform(-10, 10), rng.uniform(0.8, 1.2),
                 rng.uniform(-10, 10))
    return {"new_size": (new_w, new_h), "crop_pos": (pos_x, pos_y),
            "crop_size": (size_x, size_y), "flip": rng.rand() > 0.5,
            "color_aug": color_aug}


def get_video_params(cfg: Config, n_frames_total: int, cur_seq_len: int,
                     index: int, rng: np.random.RandomState):
    """Temporal window + reference sampling (base_dataset.py:101-126).

    Returns (n_frames_total, start_idx, t_step, ref_indices).  Raises
    ValueError where a sample would hold fewer than n_shot references (a
    short training sequence, too few --ref_img_id): the JAX function returns
    the fewer, and its generator fails later in a reshape."""
    if cfg.is_train:
        n_frames_total = min(cur_seq_len, n_frames_total)
        max_t_step = min(cfg.max_t_step,
                         (cur_seq_len - 1) // max(1, n_frames_total - 1))
        t_step = rng.randint(max(1, max_t_step)) + 1
        offset_max = max(1, cur_seq_len - (n_frames_total - 1) * t_step)
        if cfg.is_pose:
            start_idx = index % offset_max
            max_range, min_range = 60, 14
        else:
            start_idx = rng.randint(offset_max)
            max_range, min_range = 300, 14
        ref_range = (list(range(max(0, start_idx - max_range),
                                max(1, start_idx - min_range)))
                     + list(range(min(start_idx + min_range, cur_seq_len - 1),
                                  min(start_idx + max_range, cur_seq_len))))
        ref_indices = list(rng.choice(ref_range,
                                      size=min(cfg.n_shot, len(ref_range)),
                                      replace=False))
        if len(ref_indices) < cfg.n_shot:
            raise ValueError(
                f"n_shot {cfg.n_shot}: a sequence of {cur_seq_len} frames holds "
                f"only {len(ref_range)} reference frames at least {min_range} "
                f"frames from its start frame {start_idx}; use longer sequences "
                f"or a smaller --n_shot")
    else:
        n_frames_total = 1
        start_idx = index
        t_step = 1
        ref_indices = [int(i) for i in str(cfg.ref_img_id).split(",")]
        if len(ref_indices) < cfg.n_shot:
            raise ValueError(
                f"n_shot {cfg.n_shot}: --ref_img_id {cfg.ref_img_id!r} names "
                f"{len(ref_indices)} reference frames")
    return n_frames_total, start_idx, t_step, ref_indices


def apply_transform(cfg: Config, img: Image.Image, params: Dict,
                    method=Image.BICUBIC, normalize: bool = True,
                    color_aug: bool = False) -> np.ndarray:
    """Compose scale -> crop -> color-aug -> flip -> [0,1] -> normalize
    (base_dataset.py:128-170).  Returns float32 HWC."""
    img = img.resize(params["new_size"], method)
    if "crop" in cfg.resize_or_crop:
        x1, y1 = params["crop_pos"]
        tw, th = params["crop_size"]
        img = img.crop((x1, y1, x1 + tw, y1 + th))
    if cfg.is_train and color_aug:
        img = _color_aug(img, params["color_aug"])
    if cfg.is_train and not cfg.no_flip and params["flip"]:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if normalize:
        arr = (arr - 0.5) / 0.5
    return arr


def _color_aug(img: Image.Image, params) -> Image.Image:
    """HSV jitter (base_dataset.py:164-170)."""
    h_b, s_a, s_b, v_a, v_b = params
    h, s, v = img.convert("HSV").split()
    h = h.point(lambda i: (i + h_b) % 256)
    s = s.point(lambda i: min(255, max(0, i * s_a + s_b)))
    v = v.point(lambda i: min(255, max(0, i * v_a + v_b)))
    return Image.merge("HSV", (h, s, v)).convert("RGB")
