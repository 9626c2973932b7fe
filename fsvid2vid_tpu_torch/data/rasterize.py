"""Keypoints -> label images (the port's copy of
fsvid2vid_tpu/data/rasterize.py; reference data/keypoint2img.py and the face
edge drawing of fewshot_face_dataset.get_face_image): face landmarks to edge
maps, and OpenPose JSON (body, face and hands) to the RGB pose image.

The reference's scipy `curve_fit` quadratic/linear fits
(keypoint2img.py:299-321) are closed-form `np.polyfit` fits, the same
least-squares solutions.  The thick-polyline stamping runs in C++
(native/rasterizer.cc), built with g++ into fsvid2vid_tpu_torch/build/ at
first use and loaded with ctypes; a build that fails raises.  The numpy
stamping runs only when the caller passes native=False.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
NATIVE_SOURCE = _PKG / "native" / "rasterizer.cc"
NATIVE_LIBRARY = _PKG / "build" / "librasterizer.so"


# ---------------------------------------------------------------------------
# OpenPose edge topology (keypoint2img.py:205-257)
# ---------------------------------------------------------------------------

POSE_EDGE_LIST_BASIC = [
    [17, 15], [15, 0], [0, 16], [16, 18],
    [0, 1], [1, 8],
    [1, 2], [2, 3], [3, 4],
    [1, 5], [5, 6], [6, 7],
    [8, 9], [9, 10], [10, 11],
    [8, 12], [12, 13], [13, 14],
]
POSE_COLOR_LIST_BASIC = [
    [153, 0, 153], [153, 0, 102], [102, 0, 153], [51, 0, 153],
    [153, 0, 51], [153, 0, 0],
    [153, 51, 0], [153, 102, 0], [153, 153, 0],
    [102, 153, 0], [51, 153, 0], [0, 153, 0],
    [0, 153, 51], [0, 153, 102], [0, 153, 153],
    [0, 102, 153], [0, 51, 153], [0, 0, 153],
]
POSE_EDGE_LIST_FEET = [[11, 24], [11, 22], [22, 23], [14, 21], [14, 19], [19, 20]]
POSE_COLOR_LIST_FEET = [[0, 153, 153]] * 3 + [[0, 0, 153]] * 3

HAND_EDGE_LIST = [
    [0, 1, 2, 3, 4], [0, 5, 6, 7, 8], [0, 9, 10, 11, 12],
    [0, 13, 14, 15, 16], [0, 17, 18, 19, 20],
]
HAND_COLOR_LIST = [[204, 0, 0], [163, 204, 0], [0, 204, 82], [0, 82, 204],
                   [163, 0, 204]]

FACE_LIST = [
    [list(range(0, 17))],
    [list(range(17, 22))],
    [list(range(22, 27))],
    [[28, 31], list(range(31, 36)), [35, 28]],
    [[36, 37, 38, 39], [39, 40, 41, 36]],
    [[42, 43, 44, 45], [45, 46, 47, 42]],
    [list(range(48, 55)), [54, 55, 56, 57, 58, 59, 48]],
]


# 68/83-pt face-landmark part list (fewshot_face_dataset.py:52-59)
def face_part_list(add_upper_face: bool) -> List[List[List[int]]]:
    return [
        [list(range(0, 17)) + ((list(range(68, 83)) + [0])
                               if add_upper_face else [])],  # face outline
        [list(range(17, 22))],                               # right eyebrow
        [list(range(22, 27))],                               # left eyebrow
        [[28, 31], list(range(31, 36)), [35, 28]],           # nose
        [[36, 37, 38, 39], [39, 40, 41, 36]],                # right eye
        [[42, 43, 44, 45], [45, 46, 47, 42]],                # left eye
        [list(range(48, 55)), [54, 55, 56, 57, 58, 59, 48],  # mouth + tongue
         list(range(60, 65)), [64, 65, 66, 67, 60]],
    ]


def edge_lists(basic_point_only: bool):
    """(pose edges, pose colors, hand edges, hand colors, face edges); the
    feet edges unless basic_point_only."""
    pose_edges = list(POSE_EDGE_LIST_BASIC)
    pose_colors = list(POSE_COLOR_LIST_BASIC)
    if not basic_point_only:
        pose_edges += POSE_EDGE_LIST_FEET
        pose_colors += POSE_COLOR_LIST_FEET
    return pose_edges, pose_colors, HAND_EDGE_LIST, HAND_COLOR_LIST, FACE_LIST


# ---------------------------------------------------------------------------
# curve interpolation + drawing (keypoint2img.py:260-321)
# ---------------------------------------------------------------------------

def interp_points(x: np.ndarray, y: np.ndarray):
    """Quadratic (>=3 pts) / linear (2 pts) least-squares curve through the
    keypoints, sampled at ~1px spacing.  Returns (None, None) for degenerate
    or too-curved (|a| > 1) fits, matching keypoint2img.py:299-321."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if np.abs(x[:-1] - x[1:]).max() < np.abs(y[:-1] - y[1:]).max():
        curve_y, curve_x = interp_points(y, x)
        if curve_y is None:
            return None, None
        return curve_x, curve_y
    try:
        if len(x) < 3:
            popt = np.polyfit(x, y, 1)
        else:
            popt = np.polyfit(x, y, 2)
            if abs(popt[0]) > 1:
                return None, None
    except (np.linalg.LinAlgError, ValueError):
        return None, None
    if x[0] > x[-1]:
        x = x[::-1]
    num = int(round(x[-1] - x[0]))
    if num < 1:
        curve_x = np.asarray([x[0]])
    else:
        curve_x = np.linspace(x[0], x[-1], num)
    curve_y = np.polyval(popt, curve_x)
    return curve_x.astype(int), curve_y.astype(int)


def set_color(im: np.ndarray, yy: np.ndarray, xx: np.ndarray, color):
    """keypoint2img.py:267-276 — note the reference's quirk of averaging ALL
    selected pixels when ANY is already set; replicated for parity."""
    if im.ndim == 3:
        if (im[yy, xx] == 0).all():
            im[yy, xx] = color
        else:
            im[yy, xx] = ((im[yy, xx].astype(float) + np.asarray(color)) / 2
                          ).astype(np.uint8)
    else:
        im[yy, xx] = color[0]


class NativeRasterizer:
    """native/rasterizer.cc as a shared library, built with g++ at first use
    (or when the source is newer than the library) and loaded once per
    process.  g++ writes to a temporary file that is renamed when it
    succeeds, so processes building at once never load a half-written
    library."""

    def __init__(self, source: Path = NATIVE_SOURCE, library: Path = NATIVE_LIBRARY):
        self.source = source
        self.library = library
        self._lib = None
        self._lock = threading.Lock()

    def build(self) -> None:
        self.library.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.library.parent)
        os.close(fd)
        try:
            proc = subprocess.run(
                ["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-shared",
                 "-o", tmp, str(self.source)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}) on "
                                   f"{self.source.name}:\n{proc.stderr}")
            os.replace(tmp, self.library)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                if (not self.library.exists() or self.library.stat().st_mtime
                        < self.source.stat().st_mtime):
                    self.build()
                lib = ctypes.CDLL(str(self.library))
                lib.draw_edge.argtypes = [
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int]
                lib.draw_edge.restype = None
                self._lib = lib
            return self._lib


NATIVE = NativeRasterizer()


def draw_edge(im: np.ndarray, x, y, bw: int = 1, color=(255, 255, 255),
              draw_end_points: bool = False, native: bool = True):
    """Thick polyline stamping (keypoint2img.py:279-296) into a uint8 HW or
    HW3 image, in place: in C++ by default, in numpy with native=False (the
    same semantics, the overlap-averaging quirk included)."""
    if x is None or np.size(x) == 0:
        return
    h, w = im.shape[:2]
    x = np.asarray(x)
    y = np.asarray(y)

    if native:
        if im.dtype != np.uint8 or not im.flags["C_CONTIGUOUS"] or im.ndim not in (2, 3):
            raise ValueError("the native stamper takes a C-contiguous uint8 "
                             f"HW or HW3 image, not {im.dtype} {im.shape}")
        xs = np.ascontiguousarray(x, np.int32)
        ys = np.ascontiguousarray(y, np.int32)
        col = np.ascontiguousarray(list(color)[:3], np.uint8)
        channels = 3 if im.ndim == 3 else 1
        NATIVE.load().draw_edge(im.ctypes.data, h, w, channels, xs.ctypes.data,
                                ys.ctypes.data, len(xs), bw, col.ctypes.data,
                                int(draw_end_points))
        return

    for i in range(-bw, bw):
        for j in range(-bw, bw):
            yy = np.clip(y + i, 0, h - 1)
            xx = np.clip(x + j, 0, w - 1)
            set_color(im, yy, xx, color)
    if draw_end_points:
        ends_y = np.asarray([y[0], y[-1]])
        ends_x = np.asarray([x[0], x[-1]])
        for i in range(-bw * 2, bw * 2):
            for j in range(-bw * 2, bw * 2):
                if i * i + j * j < 4 * bw * bw:
                    yy = np.clip(ends_y + i, 0, h - 1)
                    xx = np.clip(ends_x + j, 0, w - 1)
                    set_color(im, yy, xx, color)


# ---------------------------------------------------------------------------
# openpose json -> pose image (keypoint2img.py:17-120)
# ---------------------------------------------------------------------------

def extract_valid_keypoints(pts: np.ndarray, lists) -> np.ndarray:
    """(P, 3) OpenPose points with confidences -> (P, 2), zero where not
    confident (face and hand points only where their whole edge is)."""
    _, _, hand_edge_list, _, face_list = lists
    p = pts.shape[0]
    thre = 0.1 if p == 70 else 0.01
    output = np.zeros((p, 2))
    if p == 70:
        for edge_list in face_list:
            for edge in edge_list:
                if (pts[edge, 2] > thre).all():
                    output[edge, :] = pts[edge, :2]
    elif p == 21:
        for edge in hand_edge_list:
            if (pts[edge, 2] > thre).all():
                output[edge, :] = pts[edge, :2]
    else:
        valid = pts[:, 2] > thre
        output[valid, :] = pts[valid, :2]
    return output


def connect_keypoints(pts, lists, size, basic_point_only, remove_face_labels,
                      is_train: bool, rng: np.random.RandomState,
                      native: bool = True):
    """Draw the body, hand and face edges into an RGB canvas
    (keypoint2img.py:78-120); in training the line widths are random."""
    pose_pts, face_pts, hand_pts_l, hand_pts_r = pts
    w, h = size
    body_edges = np.zeros((h, w, 3), np.uint8)
    pose_edge_list, pose_color_list, hand_edge_list, hand_color_list, face_list = lists

    person_h = int(pose_pts[:, 1].max() - pose_pts[:, 1].min())
    bw = rng.randint(2, 5) if is_train else max(1, person_h // 150)
    for i, edge in enumerate(pose_edge_list):
        x, y = pose_pts[edge, 0], pose_pts[edge, 1]
        if 0 not in x:
            curve_x, curve_y = interp_points(x, y)
            draw_edge(body_edges, curve_x, curve_y, bw=bw,
                      color=pose_color_list[i], draw_end_points=True, native=native)

    if not basic_point_only:
        bw = rng.randint(1, 3) if is_train else max(1, person_h // 450)
        for hand_pts in [hand_pts_l, hand_pts_r]:
            for i, edge in enumerate(hand_edge_list):
                for j in range(len(edge) - 1):
                    sub_edge = edge[j:j + 2]
                    x, y = hand_pts[sub_edge, 0], hand_pts[sub_edge, 1]
                    if 0 not in x:
                        line_x, line_y = interp_points(x, y)
                        draw_edge(body_edges, line_x, line_y, bw=bw,
                                  color=hand_color_list[i], native=native)
        edge_len = 2
        bw = rng.randint(1, 3) if is_train else max(1, person_h // 450)
        if not remove_face_labels:
            for edge_list in face_list:
                for edge in edge_list:
                    for i in range(0, max(1, len(edge) - 1), edge_len - 1):
                        sub_edge = edge[i:i + edge_len]
                        x, y = face_pts[sub_edge, 0], face_pts[sub_edge, 1]
                        if 0 not in x:
                            curve_x, curve_y = interp_points(x, y)
                            draw_edge(body_edges, curve_x, curve_y, bw=bw,
                                      native=native)
    return body_edges


def read_keypoints(json_input, size, basic_point_only: bool,
                   remove_face_labels: bool, is_train: bool,
                   rng: np.random.RandomState, ppl_idx: Optional[int] = None,
                   native: bool = True):
    """OpenPose JSON (a path or the text) -> (pose image (H, W, 3) uint8,
    body points (25, 2), face points (70, 2)) of the tallest person, or of
    person `ppl_idx` when given (keypoint2img.py:17-53)."""
    if isinstance(json_input, (str, bytes)) and str(json_input).endswith(".json"):
        with open(json_input, encoding="utf-8") as f:
            people = json.load(f)["people"]
    else:
        people = json.loads(json_input)["people"]

    lists = edge_lists(basic_point_only)
    w, h = size
    pose_img = np.zeros((h, w, 3), np.uint8)
    pose_keypoints = np.zeros((25, 2))
    face_keypoints = np.zeros((70, 2))
    y_len_max = 0
    if ppl_idx is not None and ppl_idx < len(people):
        people = [people[ppl_idx]]
    for person in people:
        pose_pts = np.array(person["pose_keypoints_2d"]).reshape(25, 3)
        face_pts = np.array(person["face_keypoints_2d"]).reshape(70, 3)
        hand_l = np.array(person["hand_left_keypoints_2d"]).reshape(21, 3)
        hand_r = np.array(person["hand_right_keypoints_2d"]).reshape(21, 3)
        pts = [extract_valid_keypoints(p, lists)
               for p in [pose_pts, face_pts, hand_l, hand_r]]
        y = pts[0][:, 1]
        y_len = y.max() - y.min()
        if y_len > y_len_max:
            y_len_max = y_len
            pose_img = connect_keypoints(pts, lists, size, basic_point_only,
                                         remove_face_labels, is_train, rng, native)
            pose_keypoints = pts[0]
            face_keypoints = pts[1]
    return pose_img, pose_keypoints, face_keypoints


# ---------------------------------------------------------------------------
# face-landmark edge maps (fewshot_face_dataset.get_face_image :155-171)
# ---------------------------------------------------------------------------

def draw_face_edges(keypoints: np.ndarray, part_list, size: Tuple[int, int],
                    bw: int, native: bool = True) -> np.ndarray:
    """68/83-pt landmarks -> single-channel edge map (uint8 HW)."""
    w, h = size
    edge_len = 3
    im_edges = np.zeros((h, w), np.uint8)
    for edge_list in part_list:
        for edge in edge_list:
            for i in range(0, max(1, len(edge) - 1), edge_len - 1):
                sub_edge = edge[i:i + edge_len]
                x = keypoints[sub_edge, 0]
                y = keypoints[sub_edge, 1]
                curve_x, curve_y = interp_points(x, y)
                draw_edge(im_edges, curve_x, curve_y, bw=bw, native=native)
    return im_edges


def add_upper_face_points(keypoints: np.ndarray) -> np.ndarray:
    """Synthesize the upper face outline by symmetry
    (fewshot_face_dataset.py:182-187): mirror outline points 1..15 about the
    ear baseline, scaled by 2/3."""
    pts = keypoints[:17].astype(np.int32)
    baseline_y = (pts[0, 1] + pts[-1, 1]) / 2
    upper = pts[1:-1].copy()
    upper[:, 1] = baseline_y + (baseline_y - upper[:, 1]) * 2 // 3
    return np.vstack((keypoints, upper[::-1]))
