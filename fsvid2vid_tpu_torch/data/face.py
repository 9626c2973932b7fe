"""Few-shot face dataset (the port's copy of fsvid2vid_tpu/data/face.py;
reference data/fewshot_face_dataset.py): 68/83-pt landmark .txt files ->
edge maps + RGB frames, with cross-identity keypoint normalization by
per-part mean distances and stateful sliding windows at inference."""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
from PIL import Image

from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.data.files import (
    make_dataset, make_grouped_dataset, check_path_valid)
from fsvid2vid_tpu_torch.data.rasterize import (
    add_upper_face_points, draw_face_edges, face_part_list)
from fsvid2vid_tpu_torch.data.transforms import (
    apply_transform, get_img_params, get_video_params)

# per-part landmark groups for normalization (fewshot_face_dataset.py:228-236)
NORM_PART_LIST = [
    [0, 16], [1, 15], [2, 14], [3, 13], [4, 12], [5, 11], [6, 10], [7, 9, 8],
    [17, 26], [18, 25], [19, 24], [20, 23], [21, 22],
    [27], [28], [29], [30], [31, 35], [32, 34], [33],
    [36, 45], [37, 44], [38, 43], [39, 42], [40, 47], [41, 46],
    [48, 54], [49, 53], [50, 52], [51], [55, 59], [56, 58], [57],
    [60, 64], [61, 63], [62], [65, 67], [66],
]
UPPER_PART_LIST = [[68, 82], [69, 81], [70, 80], [71, 79], [72, 78], [73, 77],
                   [74, 76, 75]]


class FewshotFaceDataset:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        root = cfg.dataroot
        if cfg.is_train:
            self.L_paths = sorted(make_grouped_dataset(
                os.path.join(root, "train_keypoints")))
            self.I_paths = sorted(make_grouped_dataset(
                os.path.join(root, "train_images")))
            check_path_valid(self.L_paths, self.I_paths)
        else:
            self.L_paths = sorted(make_dataset(
                cfg.seq_path.replace("images", "keypoints")))
            self.I_paths = sorted(make_dataset(cfg.seq_path))
            self.ref_L_paths = sorted(make_dataset(
                cfg.ref_img_path.replace("images", "keypoints")))
            self.ref_I_paths = sorted(make_dataset(cfg.ref_img_path))
        self.n_of_seqs = len(self.I_paths)
        self.n_frames_total = 1  # curriculum-controlled

        self.add_upper_face = not cfg.no_upper_face
        self.part_list = face_part_list(self.add_upper_face)
        n = 83 if self.add_upper_face else 68
        self.ref_dist_x = [None] * n
        self.ref_dist_y = [None] * n
        self.dist_scale_x = [None] * n
        self.dist_scale_y = [None] * n
        self.img_scale = None
        self.fix_crop_pos = True
        # inference caches (stateful across frame indices, test.py protocol)
        self._Lr = self._Ir = None
        self._crop_coords = None
        self._all_keypoints = None
        self._scale = None
        self._bw = 1

    def __len__(self):
        if not self.cfg.is_train:
            return len(self.L_paths)
        return max(10000, max(len(a) for a in self.L_paths))

    # ------------------------------------------------------------------
    def sample(self, index: int, rng: np.random.RandomState) -> Dict:
        cfg = self.cfg
        if cfg.is_train:
            seq_idx = rng.randint(self.n_of_seqs)
            L_paths = self.L_paths[seq_idx]
            I_paths = self.I_paths[seq_idx]
            ref_L_paths, ref_I_paths = L_paths, I_paths
        else:
            L_paths, I_paths = self.L_paths, self.I_paths
            ref_L_paths, ref_I_paths = self.ref_L_paths, self.ref_I_paths

        nft, start_idx, t_step, ref_indices = get_video_params(
            cfg, self.n_frames_total, len(I_paths), index, rng)
        w = cfg.fine_size
        h = int(cfg.fine_size / cfg.aspect_ratio)
        params = get_img_params(cfg, (w, h), rng)
        is_first = cfg.is_train or index == 0

        # ---- references ----
        if is_first:
            kp = np.loadtxt(ref_L_paths[ref_indices[0]], delimiter=",")
            ref_crop = self._get_crop_coords(kp, rng, for_ref=True)
            self._bw = max(1, (ref_crop[1] - ref_crop[0]) // 256)
            ref_kp_paths = [ref_L_paths[i] for i in ref_indices]
            all_kp_ref = self._read_all_keypoints(ref_kp_paths, ref_crop,
                                                  is_ref=True)
            Lr, Ir = [], []
            for i, idx in enumerate(ref_indices):
                img = self._crop(Image.open(ref_I_paths[idx]), ref_crop)
                Lr.append(self._face_label(all_kp_ref[i], img.size, params))
                Ir.append(apply_transform(cfg, img, params, color_aug=True))
            Lr, Ir = np.stack(Lr), np.stack(Ir)
            if not cfg.is_train:
                self._Lr, self._Ir = Lr, Ir
        else:
            Lr, Ir = self._Lr, self._Ir

        # ---- targets ----
        if is_first:
            kp = np.loadtxt(L_paths[start_idx], delimiter=",")
            crop = self._get_crop_coords(kp, rng)
            if not cfg.is_train:
                self._crop_coords = crop
            self._bw = max(1, (crop[1] - crop[0]) // 256)
            end_idx = (start_idx + nft * t_step if cfg.is_train
                       else start_idx + cfg.how_many)
            kp_paths = L_paths[start_idx:end_idx:t_step]
            all_kp = self._read_all_keypoints(kp_paths, crop, is_ref=False)
            if not cfg.is_train:
                self._all_keypoints = all_kp
        else:
            crop = self._crop_coords
            all_kp = self._all_keypoints

        L, I = [], []
        for t in range(nft):
            ti = t if cfg.is_train else start_idx + t
            kp_t = all_kp[min(ti, len(all_kp) - 1)]
            img = self._crop(Image.open(I_paths[start_idx + t * t_step]), crop)
            L.append(self._face_label(kp_t, img.size, params))
            I.append(apply_transform(cfg, img, params, color_aug=True))
        return {"tgt_label": np.stack(L), "tgt_image": np.stack(I),
                "ref_labels": Lr, "ref_images": Ir,
                "path": I_paths[start_idx + (nft - 1) * t_step]}

    # ------------------------------------------------------------------
    def _face_label(self, keypoints, size, params) -> np.ndarray:
        edges = draw_face_edges(keypoints, self.part_list, size, self._bw)
        return apply_transform(self.cfg, Image.fromarray(edges), params,
                               method=Image.BILINEAR, normalize=False)

    @staticmethod
    def _crop(img: Image.Image, coords):
        min_y, max_y, min_x, max_x = coords
        return img.crop((min_x, min_y, max_x, max_y))

    def _read_all_keypoints(self, paths, crop_coords, is_ref: bool):
        kps = [self._read_keypoints(p, crop_coords) for p in paths]
        if not self.cfg.is_train or self.n_frames_total > 4:
            self._normalize_faces(kps, is_ref=is_ref)
        return kps

    def _read_keypoints(self, path, crop_coords):
        kp = np.loadtxt(path, delimiter=",")
        if crop_coords is None:
            crop_coords = self._get_crop_coords(kp, np.random.RandomState(0))
        kp = kp.copy()
        kp[:, 0] -= crop_coords[2]
        kp[:, 1] -= crop_coords[0]
        if self.add_upper_face:
            kp = add_upper_face_points(kp)
        return kp

    def _get_crop_coords(self, keypoints, rng, crop_size=None, for_ref=False):
        """fewshot_face_dataset.py:191-216."""
        cfg = self.cfg
        min_y, max_y = int(keypoints[:, 1].min()), int(keypoints[:, 1].max())
        min_x, max_x = int(keypoints[:, 0].min()), int(keypoints[:, 0].max())
        x_cen, y_cen = (min_x + max_x) // 2, (min_y + max_y) // 2
        w = h = max_x - min_x
        if crop_size is not None:
            h, w = crop_size[0] / 2, crop_size[1] / 2
        if cfg.is_train and self.fix_crop_pos:
            offset = [rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2)]
            if for_ref or self._scale is None:
                self._scale = [rng.uniform(0.8, 1.2), rng.uniform(0.8, 1.2)]
            w *= self._scale[0]
            h *= self._scale[1]
            x_cen += int(offset[0] * w)
            y_cen += int(offset[1] * h)
        min_x = x_cen - w
        min_y = y_cen - h * 1.25
        max_x = min_x + w * 2
        max_y = min_y + h * 2
        return int(min_y), int(max_y), int(min_x), int(max_x)

    def _normalize_faces(self, all_keypoints, is_ref: bool):
        """Cross-identity per-part scale normalization
        (fewshot_face_dataset.py:218-264)."""
        cfg = self.cfg
        central = [8]
        face_centers = [np.mean(kp[central], axis=0) for kp in all_keypoints]
        compute_mean = not is_ref
        if compute_mean:
            if cfg.is_train:
                img_scale = 1.0
            else:
                span = (all_keypoints[0][:, 0].max()
                        - all_keypoints[0][:, 0].min())
                img_scale = self.img_scale / max(span, 1e-6)

        part_list = list(NORM_PART_LIST)
        if self.add_upper_face:
            part_list += UPPER_PART_LIST

        for i, pts_idx in enumerate(part_list):
            if compute_mean or is_ref:
                dists_x, dists_y = [], []
                for k, kp in enumerate(all_keypoints):
                    pts = kp[pts_idx]
                    pts_cen = np.mean(pts, axis=0)
                    for pt in pts:
                        dists_x.append(np.linalg.norm(pt - pts_cen))
                        dists_y.append(np.linalg.norm(pts_cen - face_centers[k]))
                mean_dist_x = sum(dists_x) / len(dists_x) + 1e-3
                mean_dist_y = sum(dists_y) / len(dists_y) + 1e-3
            if is_ref:
                self.ref_dist_x[i] = mean_dist_x
                self.ref_dist_y[i] = mean_dist_y
                self.img_scale = (all_keypoints[0][:, 0].max()
                                  - all_keypoints[0][:, 0].min())
            else:
                if compute_mean:
                    self.dist_scale_x[i] = self.ref_dist_x[i] / mean_dist_x / img_scale
                    self.dist_scale_y[i] = self.ref_dist_y[i] / mean_dist_y / img_scale
                for k, kp in enumerate(all_keypoints):
                    pts = kp[pts_idx]
                    pts_cen = np.mean(pts, axis=0)
                    face_cen = face_centers[k]
                    pts = ((pts - pts_cen) * self.dist_scale_x[i]
                           + (pts_cen - face_cen) * self.dist_scale_y[i]
                           + face_cen)
                    all_keypoints[k][pts_idx] = pts
