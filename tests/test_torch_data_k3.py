"""The port's face data pipeline at n_shot = 3 against the JAX package's:
training samples and loader batches hold three references drawn as the JAX
loader draws them (at least 14 frames from the start frame), equal in every
array; test mode reads the references --ref_img_id names.  Where a sample
would hold fewer references than n_shot (a short sequence, too few
--ref_img_id), the port raises at once, naming n_shot; the JAX function
returns the fewer and its generator fails later inside a reshape."""
import os

import numpy as np
import pytest

from fsvid2vid_tpu.data import face as jface
from fsvid2vid_tpu.data import loader as jloader
from fsvid2vid_tpu_torch.data import face as tface
from fsvid2vid_tpu_torch.data import loader as tloader
from tests.test_torch_data import assert_same, configs, write_face_dataset

K = 3
LONG = 32   # frames per sequence: from any start frame, 3 or more lie 14 away


@pytest.fixture(scope="module")
def long_root(tmp_path_factory):
    return write_face_dataset(str(tmp_path_factory.mktemp("face_k3")), n_frames=LONG,
                              size=64, seed=3)


@pytest.fixture(scope="module")
def short_root(tmp_path_factory):
    return write_face_dataset(str(tmp_path_factory.mktemp("face_short")), n_frames=12,
                              size=64, seed=4)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_batches_at_k3_equal_jax(long_root, num_workers):
    jcfg, tcfg = configs(long_root, n_shot=K, batch_size=3)
    args = dict(steps_per_epoch=3, seed=11)
    jl = jloader.SequenceLoader(jcfg, num_workers=0, **args)
    tl = tloader.SequenceLoader(tcfg, num_workers=num_workers, **args)
    for loader in (jl, tl):
        loader.set_epoch_frames(2)
    want, got = list(jl.epoch(2)), list(tl.epoch(2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["ref_labels"].shape[:2] == g["ref_images"].shape[:2] == (3, K)
        assert g["paths"] == w["paths"]
        assert_same(g, w)


def test_test_mode_reads_the_named_references(long_root):
    kw = dict(is_train=False, n_shot=K, how_many=2, ref_img_id="0,5,9",
              seq_path=os.path.join(long_root, "test_images", "0001/"),
              ref_img_path=os.path.join(long_root, "test_images", "0002/"))
    jcfg, tcfg = configs(long_root, **kw)
    jds, tds = jface.FewshotFaceDataset(jcfg), tface.FewshotFaceDataset(tcfg)
    jrng, trng = np.random.RandomState(0), np.random.RandomState(0)
    for i in range(2):
        want, got = jds.sample(i, jrng), tds.sample(i, trng)
        assert got["ref_labels"].shape[0] == K
        assert_same(got, want)


def test_a_sequence_too_short_for_n_shot_fails_naming_it(short_root):
    """12 frames: at most 2 frames lie 14 or more from a start frame."""
    jcfg, tcfg = configs(short_root, n_shot=K)
    want = jface.FewshotFaceDataset(jcfg).sample(0, np.random.RandomState(0))
    assert want["ref_labels"].shape[0] < K        # JAX returns fewer
    with pytest.raises(ValueError, match="n_shot 3: a sequence of 12 frames"):
        tface.FewshotFaceDataset(tcfg).sample(0, np.random.RandomState(0))
    loader = tloader.SequenceLoader(tcfg, steps_per_epoch=1, num_workers=2)
    with pytest.raises(ValueError, match="n_shot 3"):
        next(iter(loader.epoch(1)))


def test_too_few_reference_ids_fail_naming_n_shot(long_root):
    _, tcfg = configs(long_root, is_train=False, n_shot=2, ref_img_id="0",
                      seq_path=os.path.join(long_root, "test_images", "0001/"),
                      ref_img_path=os.path.join(long_root, "test_images", "0002/"))
    with pytest.raises(ValueError, match="n_shot 2: --ref_img_id '0' names 1"):
        tface.FewshotFaceDataset(tcfg).sample(0, np.random.RandomState(0))
