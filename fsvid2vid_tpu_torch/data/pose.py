"""Few-shot pose dataset (the port's copy of fsvid2vid_tpu/data/pose.py;
reference data/fewshot_pose_dataset.py): DensePose IUV renders and OpenPose
JSON -> 6-channel pose maps (DensePose 3 channels, then OpenPose 3),
person-region cropping at a random 1.4-1.6x scale, other-people removal
through the densemask INDS maps, the DensePose part-channel renormalisation,
and the single-person subsequences of all_subsequences.json when present.

A sample writes scratch state into the dataset (the test-time crop and
reference caches), so the loader's threads each sample from their own copy
(data/loader.py)."""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
from PIL import Image

from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.data.files import make_dataset, make_grouped_dataset
from fsvid2vid_tpu_torch.data.rasterize import read_keypoints
from fsvid2vid_tpu_torch.data.transforms import (
    apply_transform, get_img_params, get_video_params)


class FewshotPoseDataset:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        root = cfg.dataroot
        if cfg.is_train:
            self.img_paths = sorted(make_grouped_dataset(
                os.path.join(root, "train_images")))
            self.op_paths = sorted(make_grouped_dataset(
                os.path.join(root, "train_openpose")))
            self.dp_paths = sorted(make_grouped_dataset(
                os.path.join(root, "train_densepose")))
            self.ppl_indices = None
            subseq_path = os.path.join(root, "all_subsequences.json")
            if os.path.exists(subseq_path):
                self._apply_subsequences(subseq_path)
        else:
            self.img_paths = sorted(make_dataset(cfg.seq_path))
            self.op_paths = sorted(make_dataset(
                cfg.seq_path.replace("images", "openpose")))
            self.dp_paths = sorted(make_dataset(
                cfg.seq_path.replace("images", "densepose")))
            self.ref_img_paths = sorted(make_dataset(cfg.ref_img_path))
            self.ref_op_paths = sorted(make_dataset(
                cfg.ref_img_path.replace("images", "openpose")))
            self.ref_dp_paths = sorted(make_dataset(
                cfg.ref_img_path.replace("images", "densepose")))
            self.ppl_indices = None
        self.n_of_seqs = len(self.img_paths)
        self.n_frames_total = 1
        # inference caches
        self._Lr = self._Ir = None
        self._crop_coords = None
        self._ref_crop_coords = [None] * cfg.n_shot

    def _apply_subsequences(self, path):
        """Single-person subsequence splits from the offline tracker
        (preprocess.py:107-131; consumed fewshot_pose_dataset.py:47-63)."""
        with open(path) as f:
            sub = json.load(f)
        img_paths, op_paths, dp_paths = [], [], []
        for i, seq_idx in enumerate(sub["seq_indices"]):
            s, e = sub["start_frame_indices"][i], sub["end_frame_indices"][i]
            img_paths.append(self.img_paths[seq_idx][s:e])
            op_paths.append(self.op_paths[seq_idx][s:e])
            dp_paths.append(self.dp_paths[seq_idx][s:e])
        self.img_paths, self.op_paths, self.dp_paths = img_paths, op_paths, dp_paths
        self.ppl_indices = sub["ppl_indices"]

    def __len__(self):
        if not self.cfg.is_train:
            return len(self.img_paths)
        return max(10000, max(len(a) for a in self.img_paths))

    # ------------------------------------------------------------------
    def sample(self, index: int, rng: np.random.RandomState) -> Dict:
        cfg = self.cfg
        if cfg.is_train:
            seq_idx = rng.randint(self.n_of_seqs)
            img_paths = self.img_paths[seq_idx]
            op_paths = self.op_paths[seq_idx]
            dp_paths = self.dp_paths[seq_idx]
            ppl = (self.ppl_indices[seq_idx]
                   if self.ppl_indices is not None else None)
            ref_img_paths, ref_op_paths, ref_dp_paths, ref_ppl = (
                img_paths, op_paths, dp_paths, ppl)
        else:
            img_paths, op_paths, dp_paths = (self.img_paths, self.op_paths,
                                             self.dp_paths)
            ref_img_paths, ref_op_paths, ref_dp_paths = (
                self.ref_img_paths, self.ref_op_paths, self.ref_dp_paths)
            ppl = ref_ppl = None

        nft, start_idx, t_step, ref_indices = get_video_params(
            cfg, self.n_frames_total, len(img_paths), index, rng)
        w = cfg.fine_size
        h = int(cfg.fine_size / cfg.aspect_ratio)
        params = get_img_params(cfg, (w, h), rng)
        is_first = cfg.is_train or index == 0

        if is_first:
            ref_crop_coords = [None] * cfg.n_shot
            Lr, Ir = [], []
            for i, idx in enumerate(ref_indices):
                size = Image.open(ref_img_paths[idx]).size
                Li, Ii, ref_crop_coords[i] = self._get_images(
                    ref_img_paths, ref_op_paths, ref_dp_paths, ref_ppl, idx,
                    size, params, self._ref_crop_coords[i], rng)
                Lr.append(Li)
                Ir.append(Ii)
            Lr, Ir = np.stack(Lr), np.stack(Ir)
            if not cfg.is_train:
                self._Lr, self._Ir = Lr, Ir
                self._ref_crop_coords = ref_crop_coords
        else:
            Lr, Ir = self._Lr, self._Ir
            ref_crop_coords = self._ref_crop_coords

        size = Image.open(img_paths[0]).size
        crop_coords = (self._crop_coords if not cfg.is_train
                       else ref_crop_coords[0])
        L, I = [], []
        for t in range(nft):
            idx = start_idx + t * t_step
            Lt, It, crop_coords = self._get_images(
                img_paths, op_paths, dp_paths, ppl, idx, size, params,
                crop_coords, rng)
            L.append(Lt)
            I.append(It)
        if not cfg.is_train and index == 0:
            self._crop_coords = crop_coords
        return {"tgt_label": np.stack(L), "tgt_image": np.stack(I),
                "ref_labels": Lr, "ref_images": Ir, "path": img_paths[idx]}

    # ------------------------------------------------------------------
    def _get_images(self, img_paths, op_paths, dp_paths, ppl_indices, i, size,
                    params, crop_coords, rng):
        """(fewshot_pose_dataset.py:143-190)."""
        cfg = self.cfg
        ppl_idx = ppl_indices[i] if ppl_indices is not None else None

        # openpose render
        op_img, pose_pts, _ = read_keypoints(
            op_paths[i], size, cfg.basic_point_only, cfg.remove_face_labels,
            cfg.is_train, rng, ppl_idx)
        op_pil, crop_coords = self._crop_person_region(
            Image.fromarray(op_img), crop_coords, pose_pts, size, rng)
        O = apply_transform(cfg, op_pil, params, method=Image.NEAREST)

        # densepose render, other people removed via INDS mask
        dp_pil = Image.open(dp_paths[i])
        dp_pil, _ = self._crop_person_region(dp_pil, crop_coords, None, None, rng)
        dp_pil = self._remove_other_ppl(dp_pil, dp_paths[i], crop_coords, op_pil)
        D = apply_transform(cfg, dp_pil, params, method=Image.NEAREST)
        # renormalize part-index channel (fewshot_pose_dataset.py:186)
        D[..., 2] = ((D[..., 2] * 0.5 + 0.5) * 255 / 24 - 0.5) / 0.5

        Li = np.concatenate([D, O], axis=-1)  # 6-channel pose map

        img_pil = Image.open(img_paths[i]).convert("RGB")
        img_pil, _ = self._crop_person_region(img_pil, crop_coords, None, None, rng)
        Ii = apply_transform(cfg, img_pil, params, color_aug=True)
        return Li, Ii, crop_coords

    def _crop_person_region(self, img, crop_coords, pose_pts, size, rng):
        if crop_coords is None:
            offset = ([rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05)]
                      if self.cfg.is_train else [0, 0])
            crop_coords = self._get_crop_coords(pose_pts, size, offset, rng)
        return img.crop(tuple(crop_coords)), crop_coords

    def _get_crop_coords(self, pose_pts, size, offset, rng):
        """Person box from pose keypoints (fewshot_pose_dataset.py:210-243)."""
        cfg = self.cfg
        w, h = size
        valid = pose_pts[:, 0] != 0
        x, y = pose_pts[valid, 0], pose_pts[valid, 1]
        x_cen = int(x.min() + x.max()) // 2 if x.shape[0] else w // 2
        if y.shape[0]:
            y_min = max(y.min(), min(pose_pts[15, 1], pose_pts[16, 1]))
            y_max = max(pose_pts[11, 1], pose_pts[14, 1])
            if y_max == 0:
                y_max = y.max()
            y_cen = int(y_min + y_max) // 2
            y_len = y_max - y_min
        else:
            y_cen = y_len = h // 2
        scale = rng.uniform(1.4, 1.6) if cfg.is_train else 1.5
        bh = int(min(h, max(h // 4, y_len * scale))) // 2
        bw = int(bh * cfg.aspect_ratio)
        if offset is not None:
            x_cen += int(offset[0] * bw)
            y_cen += int(offset[1] * bh)
        x_cen = max(bw, min(w - bw, x_cen))
        y_cen = max(bh, min(h - bh, y_cen))
        return [x_cen - bw, y_cen - bh, x_cen + bw, y_cen + bh]

    def _remove_other_ppl(self, dp_img, dp_path, crop_coords, op_img):
        """Keep only the person whose densemask INDS id dominates the openpose
        region (fewshot_pose_dataset.py:246-263)."""
        inds_path = dp_path.replace("densepose", "densemask").replace(
            "IUV", "INDS")
        if not os.path.exists(inds_path):
            return dp_img
        inds = np.array(Image.open(inds_path).crop(tuple(crop_coords)))
        op = np.asarray(op_img)
        valid = (op[:, :, 0] > 0) | (op[:, :, 1] > 0) | (op[:, :, 2] > 0)
        dp_valid = inds[valid]
        dp_valid = dp_valid[dp_valid != 0]
        if dp_valid.size == 0:
            return dp_img
        person_id = np.bincount(dp_valid).argmax()
        mask = inds == person_id
        if mask.ndim == 2:
            mask = np.repeat(mask[:, :, None], 3, axis=2)
        return Image.fromarray(np.asarray(dp_img) * mask)
