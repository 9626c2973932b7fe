"""Face keypoints -> edge maps (the port's copy of the face part of
fsvid2vid_tpu/data/rasterize.py; reference data/keypoint2img.py and the face
edge drawing of fewshot_face_dataset.get_face_image).

The reference's scipy `curve_fit` quadratic/linear fits
(keypoint2img.py:299-321) are closed-form `np.polyfit` fits, the same
least-squares solutions.  The thick-polyline stamping runs in C++
(native/rasterizer.cc), built with g++ into fsvid2vid_tpu_torch/build/ at
first use and loaded with ctypes; a build that fails raises.  The numpy
stamping runs only when the caller passes native=False.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
NATIVE_SOURCE = _PKG / "native" / "rasterizer.cc"
NATIVE_LIBRARY = _PKG / "build" / "librasterizer.so"


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
