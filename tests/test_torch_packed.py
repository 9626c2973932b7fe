"""The port's packed store (fsvid2vid_tpu_torch/data/packed.py) against the
JAX package's, on the CPU: a round trip in the port (tests/test_aux.py's
case), and a store written by either package read by the other.  The file
format is byte for byte the same, so the files must be equal too.  Neither
package finds `lmdb` here, so `open_store` takes the packed path in both."""

import numpy as np
import pytest
from PIL import Image

from fsvid2vid_tpu.data import packed as jpacked
from fsvid2vid_tpu_torch.data import packed as tpacked

PACKAGES = {"jax": jpacked, "torch": tpacked}


@pytest.fixture
def src(tmp_path):
    rng = np.random.RandomState(0)
    root = tmp_path / "src"
    (root / "seq").mkdir(parents=True)
    (root / "seq2").mkdir()
    arr = rng.randint(0, 255, (16, 16, 3), np.uint8)
    Image.fromarray(arr).save(root / "seq" / "a.png")
    Image.fromarray(arr[::-1]).save(root / "seq2" / "c.jpg", quality=95)
    (root / "seq" / "b.txt").write_text("1,2\n3,4")
    return root, arr


def test_roundtrip(src, tmp_path):
    root, arr = src
    assert tpacked.pack_directory(str(root), str(tmp_path / "packed")) == 3
    store = tpacked.PackedStore(str(tmp_path / "packed"))
    img, key = store.getitem_by_path("seq/a.png", is_img=True)
    assert key == "seq/a.png"
    np.testing.assert_array_equal(np.asarray(img), arr)
    raw, _ = store.getitem_by_path("seq/b.txt", is_img=False)
    assert bytes(raw) == b"1,2\n3,4"
    assert sorted(store.keys()) == ["seq/a.png", "seq/b.txt", "seq2/c.jpg"]
    assert store.index["seq/b.txt"][2] == "raw" and store.index["seq2/c.jpg"][2] == "img"
    store.close()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_store_reads_across_packages(src, tmp_path, writer, reader):
    root, arr = src
    out = tmp_path / "packed"
    PACKAGES[writer].pack_directory(str(root), str(out))
    w = PACKAGES[writer].PackedStoreWriter(str(tmp_path / "bytes"))
    w.put_bytes("k", b"\x00\x01payload", kind="raw")
    w.put_file("img", str(root / "seq" / "a.png"))
    w.close()
    for store_root in (out, tmp_path / "bytes"):
        store = PACKAGES[reader].open_store(str(store_root))
        assert isinstance(store, PACKAGES[reader].PackedStore)
        for key in store.keys():
            want = PACKAGES[writer].PackedStore(str(store_root))
            assert bytes(store.get_bytes(key)) == bytes(want.get_bytes(key))
            want.close()
        store.close()
    store = PACKAGES[reader].open_store(str(out))
    img, _ = store.getitem_by_path("seq/a.png")
    np.testing.assert_array_equal(np.asarray(img), arr)
    store.close()


def test_files_equal_byte_for_byte(src, tmp_path):
    root, _ = src
    for name, pkg in PACKAGES.items():
        pkg.pack_directory(str(root), str(tmp_path / name))
    for fname in (tpacked.BLOB_NAME, tpacked.INDEX_NAME):
        with open(tmp_path / "jax" / fname, "rb") as a, \
                open(tmp_path / "torch" / fname, "rb") as b:
            assert a.read() == b.read(), fname
    assert (tpacked.BLOB_NAME, tpacked.INDEX_NAME) == (jpacked.BLOB_NAME, jpacked.INDEX_NAME)
