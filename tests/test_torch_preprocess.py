"""The port's pose preprocessing writer (fsvid2vid_tpu_torch/data/preprocess.py)
against the JAX package's, on the CPU.

Both are plain numpy and JSON, so every result must be equal, not close:
tests/test_aux.py's cases run through both packages, then
`preprocess_dataset` on the OpenPose JSON of a synthetic pose dataset
(fsvid2vid_tpu_torch/data/synthetic.py, 40 frames a sequence at 384 x 288, so
that the tracked figure is taller than the tracker's 256 pixels) writes the
same all_subsequences.json from both, and the port's pose dataset reads it.
"""
import json
import os

import numpy as np
import pytest

from fsvid2vid_tpu.data import preprocess as jpp
from fsvid2vid_tpu_torch.config import pose_config
from fsvid2vid_tpu_torch.data import preprocess as tpp
from fsvid2vid_tpu_torch.data.pose import FewshotPoseDataset
from fsvid2vid_tpu_torch.data.synthetic import write_pose_dataset
from tests.test_aux import make_person

N_FRAMES = 40


def walking_frames():
    """tests/test_aux.py's: one person walking right for 80 frames, a second
    appearing at frame 40."""
    frames = []
    for i in range(80):
        people = [make_person(100 + i * 2, 10)]
        if i >= 40:
            people.append(make_person(900 - i, 10))
        frames.append(people)
    return frames


def both(fn_name, *args, **kw):
    want = getattr(jpp, fn_name)(*args, **kw)
    got = getattr(tpp, fn_name)(*args, **kw)
    return got, want


def test_constants_equal():
    for name in ("CONF_THRE", "MIN_BODY_LEN", "TRACK_TORSO_ONLY", "POS_DIFF_VAL_THRE",
                 "POS_DIFF_NUM_THRE", "NEXT_CONF_THRE", "MOTION_THRE",
                 "MAX_STATIC_FRAMES", "N_MAX_PPL"):
        assert getattr(tpp, name) == getattr(jpp, name), name


@pytest.mark.parametrize("case", ["full_body", "valid_frame", "empty_frame", "overlap",
                                  "no_overlap", "motion_none", "motion_still",
                                  "motion_moved", "keypoint_array", "valid_keypoints"])
def test_frame_predicates_equal(case):
    p, near, far = make_person(100, 10), make_person(110, 10), make_person(500, 10)
    low = make_person(100, 10, conf=0.005)
    calls = {
        "full_body": ("is_full_body", p), "valid_frame": ("is_valid_frame", [p, far]),
        "empty_frame": ("is_valid_frame", []),
        "overlap": ("has_overlap", jpp.keypoint_array(p), jpp.keypoint_array(near)),
        "no_overlap": ("has_overlap", jpp.keypoint_array(p), jpp.keypoint_array(far)),
        "motion_none": ("detect_motion", None, [p]),
        "motion_still": ("detect_motion", [p], [make_person(100, 10)]),
        "motion_moved": ("detect_motion", [p], [make_person(130, 10)]),
        "keypoint_array": ("keypoint_array", p),
        "valid_keypoints": ("valid_keypoints", jpp.keypoint_array(low)),
    }
    got, want = both(*calls[case])
    np.testing.assert_array_equal(got, want)
    assert type(got) is type(want)


def test_static_ranges_equal():
    frames = [(i, [make_person(100, 10)]) for i in range(12)]
    frames += [(12 + i, [make_person(100 + 10 * i, 10)]) for i in range(3)]
    got, want = both("static_frame_ranges", frames)
    assert got == want and got and got[0][1] - got[0][0] > tpp.MAX_STATIC_FRAMES


@pytest.mark.parametrize("indices", [list(range(0, 5)) + list(range(50, 120)), [],
                                     list(range(3, 40))])
def test_isolated_ranges_equal(indices):
    got, want = both("isolated_frame_ranges", indices, min_n_of_frames=30)
    assert got == want


def test_tracking_and_subsequences_equal():
    frames = walking_frames()
    got, want = both("divide_sequences", frames, min_n_of_frames=20)
    assert got == want
    starts, ends, _ = got
    assert len(starts) >= 2 and all(e - s > 20 for s, e in zip(starts, ends))
    prev = None
    ppl_j = ppl_t = [-1] * tpp.N_MAX_PPL
    for people in frames:
        ppl_t = tpp.track_persons(prev, people, ppl_t)
        ppl_j = jpp.track_persons(prev, people, ppl_j)
        assert ppl_t == ppl_j
        prev = people


@pytest.fixture(scope="module")
def pose_root(tmp_path_factory):
    return write_pose_dataset(str(tmp_path_factory.mktemp("pose")), seed=5, n_seqs=2,
                              n_frames=N_FRAMES, size=(384, 288))


def test_preprocess_dataset_writes_the_same_file(pose_root, tmp_path):
    """Both packages write equal all_subsequences.json from the synthetic
    OpenPose JSON, and the port's pose dataset reads the port's file."""
    jroot = tmp_path / "jax"
    jroot.mkdir()
    os.symlink(os.path.join(pose_root, "train_openpose"), jroot / "train_openpose")
    want = jpp.preprocess_dataset(str(jroot))
    got = tpp.preprocess_dataset(pose_root)
    assert got == want
    with open(os.path.join(pose_root, "all_subsequences.json")) as f:
        written = f.read()
    with open(jroot / "all_subsequences.json") as f:
        assert written == f.read()
    # the tall figure is tracked through each whole sequence: one
    # subsequence per sequence, following openpose person 0
    assert got["seq_indices"] == [0, 1]
    assert all(e - s > 30 for s, e in zip(got["start_frame_indices"],
                                          got["end_frame_indices"]))
    assert all(set(p) == {0} for p in got["ppl_indices"])

    cfg = pose_config(dataroot=pose_root, fine_size=64, load_size=64, batch_size=1)
    ds = FewshotPoseDataset(cfg)
    assert ds.n_of_seqs == 2 and ds.ppl_indices == got["ppl_indices"]
    ds.n_frames_total = 2
    sample = ds.sample(1, np.random.RandomState(0))
    assert sample["tgt_label"].shape == (2, 128, 64, 6)
    assert np.isfinite(sample["tgt_image"]).all()
    json.loads(written)
