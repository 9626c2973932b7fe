"""The port's street data pipeline against the JAX package's, on a synthetic
street dataset (fsvid2vid_tpu_torch/data/synthetic.py `write_street_dataset`:
Cityscapes-id label PNGs of piecewise-constant regions and JPEG frames).
The same seed and index give the same sample, exactly, in every array: both
sides are numpy and PIL on the host, so nothing may differ.

Covers training mode (random scale and crop, flips, colour jitter, the
35 -> 20 class remap through nearest-neighbour resizing), a test-mode
sequence through the dataset's reference cache, and the sequence loader's
batches with worker threads.  The labels stay (H, W, 1) class indices in
[0, 19] on both sides; the one-hot encoding is the model's
(tests/test_torch_street_step.py)."""
import os

import numpy as np
import pytest

from fsvid2vid_tpu.config import street_config as jax_street_config
from fsvid2vid_tpu.data import loader as jloader
from fsvid2vid_tpu.data import street as jstreet
from fsvid2vid_tpu_torch.config import street_config
from fsvid2vid_tpu_torch.data import loader as tloader
from fsvid2vid_tpu_torch.data import street as tstreet
from fsvid2vid_tpu_torch.data.synthetic import write_street_dataset
from tests.test_torch_data import assert_same, few_threads  # noqa: F401 (autouse)

N_SEQS, N_FRAMES = 2, 6
SOURCE = (128, 256)     # (H, W) of the source frames, rescaled by every sample
FINE = 64               # 64 x 32 crops


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_street_dataset(str(tmp_path_factory.mktemp("street")), seed=5,
                                n_seqs=N_SEQS, n_frames=N_FRAMES, size=SOURCE)


def configs(root, **kw):
    kw = {"dataroot": root, "fine_size": FINE, "load_size": FINE, "batch_size": 2, **kw}
    return jax_street_config(**kw), street_config(**kw)


def assert_labels(labels):
    assert labels.shape[-1] == 1
    assert np.array_equal(labels, np.round(labels))
    assert labels.min() >= 0 and labels.max() <= 19
    assert len(np.unique(labels)) >= 4     # road, sidewalk, sky, ... survive the crop


def test_written_labels_are_cityscapes_ids(root):
    from PIL import Image
    label = Image.open(os.path.join(root, "train_labels", "0001", "00000.png"))
    assert label.mode == "L" and label.size == SOURCE[::-1]
    ids = np.unique(np.asarray(label))
    assert ids.max() <= 33 and {7, 8, 11, 23, 26} <= set(ids.tolist())
    image = Image.open(os.path.join(root, "train_images", "0001", "00000.jpg"))
    assert image.size == SOURCE[::-1]


@pytest.mark.parametrize("n_frames_total", [1, 3])
def test_training_samples_equal(root, n_frames_total):
    """Random sequences, random-width scales and crops, flips and colour
    jitter; nearest-resized, remapped labels."""
    jcfg, tcfg = configs(root)
    assert tcfg.resize_or_crop == "random_scale_and_crop" and tcfg.label_nc == 20
    jds, tds = jstreet.FewshotStreetDataset(jcfg), tstreet.FewshotStreetDataset(tcfg)
    assert len(tds) == len(jds)
    jds.n_frames_total = tds.n_frames_total = n_frames_total
    for index, seed in ((0, 3), (5, 11), (17, 12345)):
        want = jds.sample(index, np.random.RandomState(seed))
        got = tds.sample(index, np.random.RandomState(seed))
        assert got["tgt_label"].shape == (n_frames_total, 32, 64, 1)
        assert got["tgt_image"].shape == (n_frames_total, 32, 64, 3)
        assert got["path"] == want["path"]
        assert_same(got, want)
        assert_labels(got["tgt_label"])
        assert_labels(got["ref_labels"])


def test_test_mode_sequence_through_the_caches(root):
    """test.py's protocol: frame 0 reads the references into the dataset's
    cache, frames 1 and 2 reuse them; centre crops, no jitter."""
    kw = dict(is_train=False, seq_path=os.path.join(root, "test_images", "0001/"),
              ref_img_path=os.path.join(root, "test_images", "0002/"))
    jcfg, tcfg = configs(root, **kw)
    jds, tds = jstreet.FewshotStreetDataset(jcfg), tstreet.FewshotStreetDataset(tcfg)
    assert len(tds) == len(jds) == N_FRAMES
    jrng, trng = np.random.RandomState(0), np.random.RandomState(0)
    for i in range(3):
        want, got = jds.sample(i, jrng), tds.sample(i, trng)
        assert got["ref_labels"].shape == (1, 32, 64, 1)
        assert_same(got, want)
        assert_labels(got["tgt_label"])
    np.testing.assert_array_equal(tds._Lr, jds._Lr)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_batches_equal(root, num_workers):
    """SequenceLoader batches of the street dataset, prepared in worker
    threads (each with its own copy of the dataset) or not, equal the JAX
    loader's; create_dataset picks the street dataset on both sides."""
    jcfg, tcfg = configs(root, batch_size=3)
    args = dict(steps_per_epoch=2, seed=5)
    jl = jloader.SequenceLoader(jcfg, num_workers=0, **args)
    tl = tloader.SequenceLoader(tcfg, num_workers=num_workers, **args)
    assert isinstance(tl.dataset, tstreet.FewshotStreetDataset)
    for loader in (jl, tl):
        loader.set_epoch_frames(2)
    want, got = list(jl.epoch(3)), list(tl.epoch(3))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["tgt_label"].shape == (3, 2, 32, 64, 1)
        assert g["paths"] == w["paths"]
        assert_same(g, w)
        assert_labels(g["tgt_label"])
