"""Packed dataset store (port of fsvid2vid_tpu/data/packed.py; the
reference's data/lmdb_dataset.py).

The reference can read frames from LMDB to avoid many small files on network
storage.  Without an lmdb binding the same is done by a self-contained packed
format, byte for byte the JAX package's, so a store written by either
package reads in the other: one append-only blob `data.blob` per store and a
JSON index `index.json` from each original path to (offset, length, kind).
Reads are zero-copy through mmap.  `PackedStore` mirrors the reference's
`getitem_by_path` (lmdb_dataset.py:35-42); `open_store` takes an LMDB
environment with the same interface where the `lmdb` module is importable
and the directory holds one.
"""
from __future__ import annotations

import io
import json
import mmap
import os
from typing import Dict, Optional, Tuple

from PIL import Image

INDEX_NAME = "index.json"
BLOB_NAME = "data.blob"


class PackedStoreWriter:
    def __init__(self, root: str):
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.blob = open(os.path.join(root, BLOB_NAME), "wb")
        self.index: Dict[str, Tuple[int, int, str]] = {}
        self.offset = 0

    def put_file(self, key: str, src_path: str, kind: Optional[str] = None):
        with open(src_path, "rb") as f:
            data = f.read()
        if kind is None:
            kind = "img" if src_path.lower().endswith(
                (".jpg", ".jpeg", ".png")) else "raw"
        self.put_bytes(key, data, kind)

    def put_bytes(self, key: str, data: bytes, kind: str = "raw"):
        self.blob.write(data)
        self.index[key] = (self.offset, len(data), kind)
        self.offset += len(data)

    def close(self):
        self.blob.close()
        with open(os.path.join(self.root, INDEX_NAME), "w") as f:
            json.dump(self.index, f)


def pack_directory(src_root: str, dst_root: str) -> int:
    """Pack every file under src_root (recursive) keyed by relative path."""
    w = PackedStoreWriter(dst_root)
    n = 0
    for dirpath, _, fnames in sorted(os.walk(src_root)):
        for fname in sorted(fnames):
            p = os.path.join(dirpath, fname)
            w.put_file(os.path.relpath(p, src_root), p)
            n += 1
    w.close()
    return n


class PackedStore:
    """Read side; mirrors LMDBDataset.getitem_by_path (lmdb_dataset.py:35-42)."""

    def __init__(self, root: str):
        with open(os.path.join(root, INDEX_NAME)) as f:
            self.index = json.load(f)
        self._f = open(os.path.join(root, BLOB_NAME), "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)

    def keys(self):
        return self.index.keys()

    def get_bytes(self, key: str) -> bytes:
        off, length, _ = self.index[key]
        return self._mm[off:off + length]

    def getitem_by_path(self, key: str, is_img: bool = True):
        data = self.get_bytes(key)
        if is_img:
            return Image.open(io.BytesIO(data)).copy(), key
        return data, key

    def close(self):
        self._mm.close()
        self._f.close()


def open_store(root: str):
    """LMDB if available + directory is an LMDB env, else PackedStore."""
    try:
        import lmdb  # noqa: F401
        if os.path.exists(os.path.join(root, "data.mdb")):
            return _LmdbStore(root)
    except ImportError:
        pass
    return PackedStore(root)


class _LmdbStore:
    """Thin LMDB adapter with the same API (lmdb_dataset.py:12-42)."""

    def __init__(self, root: str):
        import lmdb
        self.env = lmdb.open(root, readonly=True, lock=False, readahead=False,
                             meminit=False)

    def getitem_by_path(self, key: str, is_img: bool = True):
        with self.env.begin(write=False) as txn:
            data = txn.get(key.encode() if isinstance(key, str) else key)
        if is_img:
            return Image.open(io.BytesIO(data)).copy(), key
        return data, key
