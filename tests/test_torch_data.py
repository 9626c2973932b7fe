"""The port's face data pipeline against the JAX package's, on a synthetic
face dataset: the same seed and index give the same sample, exactly, in
every array (both are numpy and PIL on the host, so nothing may differ).
Covers training mode, a test-mode sequence of 3 frames through the
dataset's state caches, the sequence loader with worker threads and host
sharding, and the port's C++ stamper against its numpy path."""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from fsvid2vid_tpu.config import face_config as jax_face_config
from fsvid2vid_tpu.data import face as jface
from fsvid2vid_tpu.data import loader as jloader
from fsvid2vid_tpu_torch.config import face_config
from fsvid2vid_tpu_torch.data import face as tface
from fsvid2vid_tpu_torch.data import loader as tloader
from fsvid2vid_tpu_torch.data import rasterize as tr

N_SEQ, N_FRAMES, IMG = 2, 12, 96
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The port's tests run tiny networks in several pytest workers at once;
    with a thread per core in each worker, the oversubscribed CPU runs them
    tens of times slower.  Two threads per worker, restored afterwards (the
    other port test files import this fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)
ARRAYS = ("tgt_label", "tgt_image", "ref_labels", "ref_images")


def face_keypoints(rng, size, jitter=1.5):
    """68 landmarks in a face layout inside a size x size image: jaw, brows,
    nose, eyes and mouth at their usual places, with a little noise."""
    s = size / 128.0
    t = np.linspace(0.15 * np.pi, 0.85 * np.pi, 17)
    kp = np.zeros((68, 2))
    kp[:17] = np.stack([64 - 38 * np.cos(t), 52 + 42 * np.sin(t)], 1)
    kp[17:22] = np.stack([np.linspace(36, 58, 5), [44, 41, 40, 41, 43]], 1)
    kp[22:27] = np.stack([np.linspace(70, 92, 5), [43, 41, 40, 41, 44]], 1)
    kp[27:31] = np.stack([[64] * 4, np.linspace(50, 68, 4)], 1)
    kp[31:36] = np.stack([np.linspace(56, 72, 5), [72, 74, 75, 74, 72]], 1)
    eye = lambda cx: np.stack([cx + 8 * np.cos(np.linspace(np.pi, 3 * np.pi, 7)[:6]),
                               52 + 3 * np.sin(np.linspace(np.pi, 3 * np.pi, 7)[:6])], 1)
    kp[36:42], kp[42:48] = eye(46), eye(82)
    m = np.linspace(0, 2 * np.pi, 13)[:12]
    kp[48:60] = np.stack([64 - 16 * np.cos(m), 86 + 6 * np.sin(m)], 1)
    m = np.linspace(0, 2 * np.pi, 9)[:8]
    kp[60:68] = np.stack([64 - 10 * np.cos(m), 86 + 3 * np.sin(m)], 1)
    return (kp + rng.uniform(-jitter, jitter, kp.shape)) * s


def write_face_dataset(root, n_seq=N_SEQ, n_frames=N_FRAMES, size=IMG, seed=0):
    """train_/test_ keypoints (.txt, 68 x 2 CSV) and images (.jpg) per
    sequence, made from `seed`."""
    rng = np.random.RandomState(seed)
    for seq in range(n_seq):
        name = f"{seq + 1:04d}"
        for sub in ("train_keypoints", "train_images", "test_keypoints", "test_images"):
            os.makedirs(os.path.join(root, sub, name), exist_ok=True)
        for f in range(n_frames):
            kp = face_keypoints(rng, size)
            img = rng.randint(0, 255, (size, size, 3), np.uint8)
            for kind in ("train", "test"):
                np.savetxt(os.path.join(root, f"{kind}_keypoints", name, f"{f:05d}.txt"),
                           kp, delimiter=",")
                Image.fromarray(img).save(
                    os.path.join(root, f"{kind}_images", name, f"{f:05d}.jpg"))
    return root


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return write_face_dataset(str(tmp_path_factory.mktemp("face")))


def configs(root, **kw):
    kw = {"dataroot": root, "fine_size": 64, "load_size": 64, "batch_size": 2, **kw}
    return jax_face_config(**kw), face_config(**kw)


def assert_same(got, want):
    for key in ARRAYS:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("n_frames_total", [1, 2, 6])
def test_training_samples_equal(data_root, n_frames_total):
    """Random sequences, crops, flips and colour jitter; 6 frames also run
    the cross-identity normalisation (n_frames_total > 4)."""
    jcfg, tcfg = configs(data_root)
    jds, tds = jface.FewshotFaceDataset(jcfg), tface.FewshotFaceDataset(tcfg)
    jds.n_frames_total = tds.n_frames_total = n_frames_total
    for index, seed in ((0, 3), (5, 11), (17, 12345)):
        want = jds.sample(index, np.random.RandomState(seed))
        got = tds.sample(index, np.random.RandomState(seed))
        assert got["tgt_label"].shape[0] == min(n_frames_total, N_FRAMES)
        assert got["path"] == want["path"]
        assert_same(got, want)
        assert got["tgt_label"].max() > 0.5   # edges were drawn


def test_test_mode_sequence_through_the_caches(data_root):
    """test.py's protocol: frame 0 encodes the references and keypoints into
    the dataset's caches, frames 1 and 2 read them."""
    kw = dict(is_train=False,
              seq_path=os.path.join(data_root, "test_images", "0001/"),
              ref_img_path=os.path.join(data_root, "test_images", "0002/"),
              ref_img_id="0,3", how_many=3)
    jcfg, tcfg = configs(data_root, **kw)
    jds, tds = jface.FewshotFaceDataset(jcfg), tface.FewshotFaceDataset(tcfg)
    assert len(tds) == len(jds) == N_FRAMES
    jrng, trng = np.random.RandomState(0), np.random.RandomState(0)
    for i in range(3):
        want, got = jds.sample(i, jrng), tds.sample(i, trng)
        assert got["ref_labels"].shape[0] == 2
        assert_same(got, want)
    np.testing.assert_array_equal(tds.dist_scale_x, jds.dist_scale_x)


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_loader_batches_equal(data_root, num_workers, shard):
    """SequenceLoader: per-(epoch, step, slot) seeding, host sharding, and
    the same batches whether the port prepares them in worker threads or
    not (each thread samples from its own copy of the dataset)."""
    shard_id, num_shards = shard
    jcfg, tcfg = configs(data_root, batch_size=4)
    args = dict(steps_per_epoch=3, shard_id=shard_id, num_shards=num_shards, seed=7)
    jl = jloader.SequenceLoader(jcfg, num_workers=0, **args)
    tl = tloader.SequenceLoader(tcfg, num_workers=num_workers, **args)
    for loader in (jl, tl):
        loader.set_epoch_frames(6)
    want, got = list(jl.epoch(2)), list(tl.epoch(2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["tgt_label"].shape[:2] == (4 // num_shards, 6)
        assert g["paths"] == w["paths"]
        assert_same(g, w)


def test_loader_stops_its_threads_when_the_consumer_stops(data_root):
    _, tcfg = configs(data_root)
    loader = tloader.SequenceLoader(tcfg, steps_per_epoch=50, num_workers=3)
    it = loader.epoch(1)
    next(it)
    it.close()
    import threading
    assert not [t for t in threading.enumerate() if t.name.startswith("loader")]


@pytest.mark.parametrize("mode", ["fewshot_pose", "fewshot_street"])
def test_unported_datasets_raise(data_root, mode):
    """Pose and street, the datasets the port once refused, are ported
    (tests/test_torch_pose_data.py, tests/test_torch_street_data.py) and
    registered: create_dataset names no ROADMAP item for them."""
    name = {"fewshot_pose": "FewshotPoseDataset",
            "fewshot_street": "FewshotStreetDataset"}[mode]
    assert tloader.DATASETS[mode].__name__ == name
    with pytest.raises(ValueError, match="unknown dataset_mode"):
        tloader.create_dataset(face_config(dataroot=data_root).replace(
            dataset_mode=mode.replace("fewshot", "unknown")))


@pytest.mark.parametrize("bw", [1, 2])
def test_native_stamper_equals_numpy(bw):
    """The C++ stamper (built with g++ on first use) against the numpy path,
    exactly: face edge maps, and RGB polylines with end points whose
    overlaps take the reference's averaging quirk."""
    rng = np.random.RandomState(bw)
    for _ in range(4):
        kp = tr.add_upper_face_points(face_keypoints(rng, 120, jitter=4.0))
        parts = tr.face_part_list(True)
        native = tr.draw_face_edges(kp, parts, (120, 128), bw)
        plain = tr.draw_face_edges(kp, parts, (120, 128), bw, native=False)
        assert native.max() == 255
        np.testing.assert_array_equal(native, plain)
    ims = [np.zeros((40, 48, 3), np.uint8) for _ in range(2)]
    for k in range(6):
        x, y = tr.interp_points(rng.uniform(0, 48, 3), rng.uniform(0, 40, 3))
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        for im, native in zip(ims, (True, False)):
            tr.draw_edge(im, x, y, bw=bw, color=color, draw_end_points=True,
                         native=native)
    np.testing.assert_array_equal(ims[0], ims[1])
    assert ims[0].any()
    assert tr.NATIVE.library.exists()


def test_native_stamper_refuses_what_it_cannot_stamp():
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        tr.draw_edge(np.zeros((8, 8), np.float32), [1, 2], [1, 2])
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        tr.draw_edge(np.zeros((8, 8), np.uint8).T[:, :4], [1, 2], [1, 2])


def test_native_build_failure_raises(tmp_path):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    lib = tr.NativeRasterizer(bad, tmp_path / "build" / "libbad.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        lib.load()
    assert not list((tmp_path / "build").iterdir())   # no half-written library
