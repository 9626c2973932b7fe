"""Filesystem helpers (the port's copy of fsvid2vid_tpu/data/files.py;
reference data/image_folder.py)."""
from __future__ import annotations

import os
from typing import List

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tiff", ".webp",
                  ".json", ".txt")


def is_image_file(fname: str) -> bool:
    return fname.lower().endswith(IMG_EXTENSIONS)


def make_dataset(directory: str) -> List[str]:
    assert os.path.isdir(directory), f"{directory} is not a valid directory"
    paths = []
    for root, _, fnames in sorted(os.walk(directory)):
        for f in sorted(fnames):
            if is_image_file(f):
                paths.append(os.path.join(root, f))
    return paths


def make_grouped_dataset(directory: str) -> List[List[str]]:
    """List of per-sequence sorted file lists (image_folder.py:63-75)."""
    assert os.path.isdir(directory), f"{directory} is not a valid directory"
    groups = []
    for root, _, fnames in sorted(os.walk(directory)):
        paths = [os.path.join(root, f) for f in sorted(fnames)
                 if is_image_file(f)]
        if paths:
            groups.append(paths)
    return groups


def check_path_valid(a, b) -> None:
    assert len(a) == len(b), f"{a[0]} vs {b[0]}"
    if a and isinstance(a[0], list):
        for ai, bi in zip(a, b):
            assert len(ai) == len(bi), f"{ai[0]} vs {bi[0]}"
