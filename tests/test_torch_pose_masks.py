"""The port's pose masks and face boxes against the JAX package's, on the
CPU: get_part_mask, smoothed_face_mask (models/input_process.py),
get_face_boxes and crop_face_region (models/face_refiner.py).  Part masks
and boxes must be equal (comparisons and min / max reductions: no
rounding); the smoothed face mask, a 225-tap f32 average, agrees to 1e-7,
face crops to 1e-5 (bilinear taps in f32).

Labels are 6-channel pose maps: channel 2 holds DensePose part ids
(id / 24 scaled to [-1, 1]) with a face blob (parts 23 and 24) at a random
place, the last three channels an OpenPose rendering with face pixels where
all three are positive."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.config import pose_config as jpose
from fsvid2vid_tpu.models import face_refiner as jfr
from fsvid2vid_tpu.models import input_process as jip
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.models import face_refiner as tfr
from fsvid2vid_tpu_torch.models import input_process as tip

ATOL = 1e-5
B, H, W = 3, 64, 32


def pose_labels(rng, faces=(True, True, True)):
    """(B, H, W, 6) labels; sample b has a DensePose face and an OpenPose
    face where faces[b]."""
    part = rng.randint(0, 23, (B, H, W))
    op = rng.uniform(-1, 0, (B, H, W, 3))
    for b, has in enumerate(faces):
        if has:
            y, x = rng.randint(4, H - 20), rng.randint(2, W - 14)
            part[b, y:y + 14, x:x + 6] = 23
            part[b, y:y + 14, x + 6:x + 12] = 24
            op[b, y + 2:y + 9, x + 1:x + 10] = rng.uniform(0.1, 1, (7, 9, 3))
    label = rng.uniform(-1, 1, (B, H, W, 6))
    label[..., 2] = (part / 24 - 0.5) * 2
    label[..., 3:] = op
    return label.astype(np.float32)


def test_part_mask_and_face_mask(rng):
    label = pose_labels(rng)
    want = np.asarray(jip.get_part_mask(jnp.asarray(label[..., 2])))
    got = tip.get_part_mask(torch.from_numpy(label[..., 2]))
    assert got.shape == (B, H, W, 9)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum(-1).max() == 1 and got[..., 8].sum() > 0   # one part each, a face
    want = np.asarray(jip.smoothed_face_mask(jnp.asarray(label[..., 2])))
    got = tip.smoothed_face_mask(torch.from_numpy(label[..., 2]))
    assert got.shape == (B, H, W, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
    assert 0 < got.max() <= 1 and got.min() == 0


CASES = {
    "densepose": dict(remove_face_labels=True),
    "openpose": dict(remove_face_labels=False),
    "basic_points": dict(remove_face_labels=False, basic_point_only=True),
}


@pytest.mark.parametrize("crop_smaller", [0, 4])
@pytest.mark.parametrize("faces", [(True, True, True), (True, False, True), (False,) * 3])
@pytest.mark.parametrize("case", list(CASES))
def test_face_boxes(rng, case, faces, crop_smaller):
    """Boxes from the DensePose face parts or from the OpenPose face
    pixels; a sample without a face gets the fallback box."""
    kw = dict(CASES[case], fine_size=W, load_size=W)
    label = pose_labels(rng, faces)
    want = np.asarray(jfr.get_face_boxes(jpose(**kw), jnp.asarray(label), crop_smaller))
    got = tfr.get_face_boxes(tconfig.pose_config(**kw), torch.from_numpy(label), crop_smaller)
    assert got.dtype == torch.float32 and got.shape == (B, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    fallback = np.array([H // 4 - H // 32 * 4, H // 4 + H // 32 * 4,
                         W // 2 - H // 32 * 4, W // 2 + H // 32 * 4]) + np.array(
        [crop_smaller, -crop_smaller, crop_smaller, -crop_smaller])
    for b, has in enumerate(faces):
        assert (got[b].numpy() == fallback).all() != has


@pytest.mark.parametrize("case", ["densepose", "openpose"])
def test_crop_face_region(rng, case):
    kw = dict(CASES[case], fine_size=W, load_size=W)
    label = pose_labels(rng)
    images = [np.tanh(rng.randn(B, H, W, 3)).astype(np.float32) for _ in range(2)]
    jcfg, tcfg = jpose(**kw), tconfig.pose_config(**kw)
    fs = tfr.face_size_of(tcfg)
    assert fs == jfr.face_size_of(jcfg) == H // 4
    want = jfr.crop_face_region(jcfg, [jnp.asarray(i) for i in images], jnp.asarray(label))
    got = tfr.crop_face_region(tcfg, [torch.from_numpy(i) for i in images],
                               torch.from_numpy(label))
    for g, w in zip(got, want):
        assert g.shape == (B, fs, fs, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    # one image; the last three channels of a wider one
    wide = np.concatenate([label, images[0]], -1)
    want = jfr.crop_face_region(jcfg, jnp.asarray(wide), jnp.asarray(label), crop_smaller=4)
    got = tfr.crop_face_region(tcfg, torch.from_numpy(wide), torch.from_numpy(label),
                               crop_smaller=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
