"""Few-shot street dataset (the port's copy of fsvid2vid_tpu/data/street.py;
reference data/fewshot_street_dataset.py): Cityscapes-style semantic label
PNGs, remapped from 35 to 20 classes, and RGB frames, scaled by a random
width in [fine_size, 1.2 fine_size) and cropped (random_scale_and_crop).

Labels leave the dataset as (H, W, 1) class indices, as the JAX dataset's
do; the train step and the inference pipeline one-hot encode them on the
device (models/input_process.py `encode_label`).  A test-mode sample caches
the references of the first index in the dataset, so the loader's threads
each sample from their own copy (data/loader.py)."""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
from PIL import Image

from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.data.files import (
    check_path_valid, make_dataset, make_grouped_dataset)
from fsvid2vid_tpu_torch.data.transforms import (
    apply_transform, get_img_params, get_video_params)

# 35 -> 20 class remap (fewshot_street_dataset.py:114-121)
LABEL_MAPPING = np.array(
    [19, 19, 19, 19, 19, 19, 19, 0, 1, 19, 19, 2, 3, 4, 19, 19, 19, 5, 19,
     6, 7, 8, 9, 18, 10, 11, 12, 13, 14, 19, 19, 15, 16, 17, 19],
    dtype=np.uint8)


class FewshotStreetDataset:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        root = cfg.dataroot
        self.L_is_label = cfg.label_nc != 0
        if cfg.is_train:
            self.L_paths = sorted(make_grouped_dataset(
                os.path.join(root, "train_labels")))
            self.I_paths = sorted(make_grouped_dataset(
                os.path.join(root, "train_images")))
            check_path_valid(self.L_paths, self.I_paths)
            self.n_of_seqs = len(self.L_paths)
        else:
            self.I_paths = sorted(make_dataset(cfg.seq_path))
            self.L_paths = sorted(make_dataset(
                cfg.seq_path.replace("images", "labels")))
            self.ref_I_paths = sorted(make_dataset(cfg.ref_img_path))
            self.ref_L_paths = sorted(make_dataset(
                cfg.ref_img_path.replace("images", "labels")))
        self.n_frames_total = 1
        self._Lr = self._Ir = None

    def __len__(self):
        if not self.cfg.is_train:
            return len(self.L_paths)
        return max(10000, sum(len(a) for a in self.L_paths))

    def _label(self, path, params) -> np.ndarray:
        """Label map as (H, W, 1) float class indices."""
        label = Image.open(path).convert("L")
        if self.cfg.label_nc == 20:
            label = Image.fromarray(LABEL_MAPPING[np.array(label)])
        out = apply_transform(self.cfg, label, params, method=Image.NEAREST,
                              normalize=False)
        return out * 255.0

    def _semantic(self, path, params) -> np.ndarray:
        if self.L_is_label:
            return self._label(path, params)
        return apply_transform(self.cfg, Image.open(path), params, color_aug=True)

    def sample(self, index: int, rng: np.random.RandomState) -> Dict:
        cfg = self.cfg
        if cfg.is_train:
            L_paths = self.L_paths[index % self.n_of_seqs]
            I_paths = self.I_paths[index % self.n_of_seqs]
            ref_L_paths, ref_I_paths = L_paths, I_paths
        else:
            L_paths, I_paths = self.L_paths, self.I_paths
            ref_L_paths, ref_I_paths = self.ref_L_paths, self.ref_I_paths

        nft, start_idx, t_step, ref_indices = get_video_params(
            cfg, self.n_frames_total, len(I_paths), index, rng)
        params = get_img_params(cfg, (cfg.width, cfg.height), rng)

        if cfg.is_train or index == 0:
            Lr = np.stack([self._semantic(ref_L_paths[i], params) for i in ref_indices])
            Ir = np.stack([apply_transform(cfg, Image.open(ref_I_paths[i]), params,
                                           color_aug=True) for i in ref_indices])
            if not cfg.is_train:
                self._Lr, self._Ir = Lr, Ir
        else:
            Lr, Ir = self._Lr, self._Ir

        L, I = [], []
        for t in range(nft):
            idx = start_idx + t * t_step
            L.append(self._semantic(L_paths[idx], params))
            I.append(apply_transform(cfg, Image.open(I_paths[idx]), params,
                                     color_aug=True))
        return {"tgt_label": np.stack(L), "tgt_image": np.stack(I),
                "ref_labels": Lr, "ref_images": Ir, "path": I_paths[idx]}
