"""The port's pose data pipeline against the JAX package's, on synthetic pose
datasets (fsvid2vid_tpu_torch/data/synthetic.py: JPEG frames, OpenPose JSON
with body, face and hand keypoints of two people, DensePose IUV PNGs, and
optionally densemask INDS maps and all_subsequences.json).  The same seed
and index give the same sample, exactly, in every array: both sides are
numpy and PIL on the host, so nothing may differ.

Covers training mode with and without the INDS maps (the other person's
DensePose parts removed or not) and with the subsequence file (per-frame
person index), a test-mode sequence through the dataset's caches, the
sequence loader's batches with worker threads, and the OpenPose rasteriser
(read_keypoints) in training and test mode, native and numpy stamping."""
import os

import numpy as np
import pytest

from fsvid2vid_tpu.config import pose_config as jax_pose_config
from fsvid2vid_tpu.data import loader as jloader
from fsvid2vid_tpu.data import pose as jpose
from fsvid2vid_tpu.data import rasterize as jr
from fsvid2vid_tpu_torch.config import pose_config
from fsvid2vid_tpu_torch.data import loader as tloader
from fsvid2vid_tpu_torch.data import pose as tpose
from fsvid2vid_tpu_torch.data import rasterize as tr
from fsvid2vid_tpu_torch.data.synthetic import write_pose_dataset
from tests.test_torch_data import assert_same, few_threads  # noqa: F401 (autouse)

N_SEQS, N_FRAMES = 2, 6
ROOTS = {"plain": dict(inds=False), "inds": dict(inds=True),
         "subsequences": dict(inds=True, subsequences=True)}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return {name: write_pose_dataset(str(tmp_path_factory.mktemp(name)), seed=3,
                                     n_seqs=N_SEQS, n_frames=N_FRAMES, **kw)
            for name, kw in ROOTS.items()}


def configs(root, **kw):
    kw = {"dataroot": root, "fine_size": 64, "load_size": 64, "batch_size": 2, **kw}
    return jax_pose_config(**kw), pose_config(**kw)


@pytest.mark.parametrize("n_frames_total", [1, 3])
@pytest.mark.parametrize("root", list(ROOTS))
def test_training_samples_equal(roots, root, n_frames_total):
    """Random sequences, person crops at a random scale and offset, flips,
    colour jitter and random line widths; 6-channel labels."""
    jcfg, tcfg = configs(roots[root])
    jds, tds = jpose.FewshotPoseDataset(jcfg), tpose.FewshotPoseDataset(tcfg)
    assert tds.n_of_seqs == jds.n_of_seqs == (2 * N_SEQS if root == "subsequences" else N_SEQS)
    jds.n_frames_total = tds.n_frames_total = n_frames_total
    for index, seed in ((0, 3), (5, 11), (17, 12345)):
        want = jds.sample(index, np.random.RandomState(seed))
        got = tds.sample(index, np.random.RandomState(seed))
        assert got["tgt_label"].shape == (n_frames_total, 128, 64, 6)
        assert got["path"] == want["path"]
        assert_same(got, want)
        assert (got["tgt_label"][..., 2] > 0.9).any()      # DensePose face parts
        assert (got["tgt_label"][..., 3:] > -1).any()       # OpenPose edges


def test_inds_maps_remove_the_other_person(roots):
    """The same draw with and without the INDS maps: only DensePose
    channels differ, and only where the second figure's parts were."""
    samples = {}
    for root in ("plain", "inds"):
        _, tcfg = configs(roots[root], fine_size=128, load_size=128)
        ds = tpose.FewshotPoseDataset(tcfg)
        samples[root] = ds.sample(0, np.random.RandomState(1))
    plain, inds = samples["plain"]["tgt_label"], samples["inds"]["tgt_label"]
    np.testing.assert_array_equal(plain[..., 3:], inds[..., 3:])
    removed = (plain[..., :3] != inds[..., :3]).any(-1)
    assert removed.any()
    assert (inds[..., 2][removed] == -1).all()   # background in the kept map


def test_test_mode_sequence_through_the_caches(roots):
    """test.py's protocol: frame 0 crops and encodes the references into the
    dataset's caches, frames 1 and 2 reuse the crop."""
    root = roots["inds"]
    kw = dict(is_train=False, seq_path=os.path.join(root, "test_images", "0001/"),
              ref_img_path=os.path.join(root, "test_images", "0002/"))
    jcfg, tcfg = configs(root, **kw)
    jds, tds = jpose.FewshotPoseDataset(jcfg), tpose.FewshotPoseDataset(tcfg)
    assert len(tds) == len(jds) == N_FRAMES
    jrng, trng = np.random.RandomState(0), np.random.RandomState(0)
    for i in range(3):
        want, got = jds.sample(i, jrng), tds.sample(i, trng)
        assert got["ref_labels"].shape == (1, 128, 64, 6)
        assert_same(got, want)
    assert tds._crop_coords == jds._crop_coords


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_batches_equal(roots, num_workers):
    """SequenceLoader batches of the pose dataset, prepared in worker threads
    (each with its own copy of the dataset) or not, equal the JAX loader's."""
    jcfg, tcfg = configs(roots["subsequences"], batch_size=3)
    args = dict(steps_per_epoch=2, seed=5)
    jl = jloader.SequenceLoader(jcfg, num_workers=0, **args)
    tl = tloader.SequenceLoader(tcfg, num_workers=num_workers, **args)
    for loader in (jl, tl):
        loader.set_epoch_frames(2)
    want, got = list(jl.epoch(3)), list(tl.epoch(3))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["tgt_label"].shape == (3, 2, 128, 64, 6)
        assert g["paths"] == w["paths"]
        assert_same(g, w)


@pytest.mark.parametrize("basic_point_only", [False, True])
@pytest.mark.parametrize("remove_face_labels", [False, True])
@pytest.mark.parametrize("is_train", [True, False])
def test_read_keypoints_equal(roots, is_train, remove_face_labels, basic_point_only):
    """OpenPose JSON -> pose image, body and face points: the tallest person,
    or the one `ppl_idx` names; feet, hands and face edges as the flags say;
    random line widths in training.  The port's native stamping and its
    numpy path both equal the JAX rasteriser."""
    path = os.path.join(roots["plain"], "train_openpose", "0001", "00002.json")
    size = (192, 256)
    for ppl_idx in (None, 1):
        want = jr.read_keypoints(path, size, basic_point_only, remove_face_labels,
                                 is_train, np.random.RandomState(4), ppl_idx)
        for native in (True, False):
            got = tr.read_keypoints(path, size, basic_point_only, remove_face_labels,
                                    is_train, np.random.RandomState(4), ppl_idx,
                                    native=native)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        assert got[0].shape == (256, 192, 3) and got[0].max() > 0
    with open(path) as f:     # the JSON text instead of a path
        text = f.read()
    args = (size, basic_point_only, remove_face_labels, is_train)
    np.testing.assert_array_equal(tr.read_keypoints(text, *args, np.random.RandomState(4))[0],
                                  jr.read_keypoints(text, *args, np.random.RandomState(4))[0])
