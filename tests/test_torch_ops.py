"""The PyTorch port's small ops against the JAX package's, on the CPU.

Inputs come from numpy with a fixed seed and go through both.  The port is
NCHW inside; its outputs are moved to channel-last to compare.  Tolerance
1e-5 everywhere: both sides compute the same f32 arithmetic, summed in
another order (resize and upsample are pure gathers and match exactly).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.ops.batch_conv import batch_conv as jax_batch_conv
from fsvid2vid_tpu.ops import image_ops as jio
from fsvid2vid_tpu.ops import warp as jwarp
from fsvid2vid_tpu_torch.ops.batch_conv import batch_conv
from fsvid2vid_tpu_torch.ops import image_ops as tio
from fsvid2vid_tpu_torch.ops import warp as twarp

ATOL = 1e-5


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("b,h,w,c", [(1, 16, 16, 3), (3, 9, 13, 4)])
def test_flow_warp_matches_jax(rng, b, h, w, c):
    """Flows of several pixels, pushing samples past the border (clamped),
    on a square map and a ragged multi-image batch."""
    img = rng.randn(b, h, w, c).astype(np.float32)
    flow = (rng.randn(b, h, w, 2) * 4).astype(np.float32)
    ref = np.asarray(jwarp.flow_warp(jnp.asarray(img), jnp.asarray(flow)))
    out = nhwc(twarp.flow_warp(nchw(img), nchw(flow)))
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_flow_warp_equals_border_grid_sample(rng):
    """The reference warps with grid_sample(align_corners=True, border) on
    the flow normalised by (W-1)/2 and (H-1)/2."""
    b, h, w, c = 2, 12, 10, 3
    img = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32))
    flow = torch.from_numpy((rng.randn(b, 2, h, w) * 3).astype(np.float32))
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    gx = (xs + flow[:, 0]) / ((w - 1) / 2) - 1
    gy = (ys + flow[:, 1]) / ((h - 1) / 2) - 1
    ref = torch.nn.functional.grid_sample(
        img, torch.stack([gx, gy], -1), mode="bilinear",
        padding_mode="border", align_corners=True)
    np.testing.assert_allclose(twarp.flow_warp(img, flow).numpy(), ref.numpy(),
                               atol=ATOL)


@pytest.mark.parametrize("k,stride,bias", [(1, 1, False), (3, 1, True), (3, 2, True)])
def test_batch_conv_matches_jax(rng, k, stride, bias):
    b, h, w, cin, cout = 3, 10, 12, 5, 7
    x = rng.randn(b, h, w, cin).astype(np.float32)
    wt = rng.randn(b, cout, cin, k, k).astype(np.float32)   # torch layout
    bs = rng.randn(b, cout).astype(np.float32) if bias else None
    ref = np.asarray(jax_batch_conv(
        jnp.asarray(x), jnp.asarray(wt.transpose(0, 3, 4, 2, 1)),
        None if bs is None else jnp.asarray(bs), stride=stride))
    out = nhwc(batch_conv(nchw(x), torch.from_numpy(wt),
                          None if bs is None else torch.from_numpy(bs),
                          stride=stride))
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("size", [(7, 5), (13, 17), (4, 12), (24, 9)])
def test_resize_nearest_matches_jax(rng, size):
    """Non-integer ratios up and down keep torch's floor(i * in/out) index."""
    x = rng.randn(2, 8, 6, 3).astype(np.float32)
    ref = np.asarray(jio.resize_nearest(jnp.asarray(x), size))
    out = nhwc(tio.resize_nearest(nchw(x), size))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("factor", [2, 3])
def test_upsample_nearest_matches_jax(rng, factor):
    x = rng.randn(2, 5, 4, 3).astype(np.float32)
    ref = np.asarray(jio.upsample_nearest(jnp.asarray(x), factor))
    out = nhwc(tio.upsample_nearest(nchw(x), factor))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("h,w", [(9, 11), (8, 8)])
def test_avg_pool_matches_jax(rng, h, w):
    """3x3 stride-2 pool with zero padding counted (the stride-2 shortcut)."""
    x = rng.randn(2, h, w, 3).astype(np.float32)
    ref = np.asarray(jio.avg_pool(jnp.asarray(x), 3, 2, 1))
    np.testing.assert_allclose(nhwc(tio.avg_pool(nchw(x), 3, 2, 1)), ref,
                               atol=ATOL)


@pytest.mark.parametrize("h,w", [(9, 11), (8, 8)])
def test_avg_pool_without_padding_count_matches_jax(rng, h, w):
    """The discriminator pyramid's pool: padding is not counted."""
    x = rng.randn(2, h, w, 3).astype(np.float32)
    ref = np.asarray(jio.avg_pool(jnp.asarray(x), 3, 2, 1, count_include_pad=False))
    out = nhwc(tio.avg_pool(nchw(x), 3, 2, 1, count_include_pad=False))
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_max_pool_matches_jax(rng):
    """The 15 x 15 stride-1 dilation of the foreground mask, and VGG's 2 x 2."""
    x = rng.randn(2, 20, 17, 2).astype(np.float32)
    for window, stride, pad in ((15, 1, 7), (2, 2, 0)):
        ref = np.asarray(jio.max_pool(jnp.asarray(x), window, stride, pad))
        np.testing.assert_array_equal(nhwc(tio.max_pool(nchw(x), window, stride, pad)), ref)


def test_channel_norm_matches_jax(rng):
    x = rng.randn(2, 6, 7, 5).astype(np.float32)
    ref = np.asarray(jio.channel_norm(jnp.asarray(x)))
    out = nhwc(tio.channel_norm(nchw(x)))
    assert out.shape == (2, 6, 7, 1)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("size", [(64, 64), (8, 20), (30, 7), (10, 12), (5, 3)])
def test_resize_bilinear_matches_jax(rng, size):
    """jax.image.resize antialiases when it shrinks (F.interpolate does not by
    default): the teacher shrinks to multiples of 64 and enlarges back."""
    x = rng.randn(2, 10, 12, 3).astype(np.float32)
    ref = np.asarray(jio.resize_bilinear(jnp.asarray(x), size))
    out = nhwc(tio.resize_bilinear(nchw(x), size))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_upsample_bilinear_matches_flownet2(rng):
    from fsvid2vid_tpu.models.flownet.flownet2 import upsample_bilinear as jup
    x = rng.randn(2, 5, 6, 2).astype(np.float32)
    ref = np.asarray(jup(jnp.asarray(x), 4))
    out = nhwc(tio.upsample_bilinear(nchw(x), 4))
    np.testing.assert_allclose(out, ref, atol=ATOL)
    # enlarging equals torch's own half-pixel bilinear
    own = torch.nn.functional.interpolate(nchw(x), scale_factor=4, mode="bilinear")
    np.testing.assert_allclose(out, nhwc(own), atol=ATOL)


def test_fg_masks_match_jax(rng):
    """Pose labels carry the DensePose part channel the masks derive from;
    face configurations have no foreground."""
    from fsvid2vid_tpu.config import pose_config as jpose
    from fsvid2vid_tpu.models import input_process as jip
    from fsvid2vid_tpu_torch.config import face_config, pose_config
    from fsvid2vid_tpu_torch.models import input_process as tip
    label = -np.ones((2, 40, 36, 6), np.float32)         # background is -1
    label[:, 14:20, 10:15] = rng.rand(2, 6, 5, 6)          # a small body blob
    ref_label = np.roll(label, 12, axis=2)
    jcfg, tcfg = jpose(), pose_config()
    want = np.asarray(jip.get_fg_mask(jcfg, jnp.asarray(label)))
    got = tip.get_fg_mask(tcfg, torch.from_numpy(label))
    assert 0.1 < want.mean() < 0.9
    np.testing.assert_array_equal(got.numpy(), want)
    want_u = np.asarray(jip.combine_fg_mask(
        jnp.asarray(want), jip.get_fg_mask(jcfg, jnp.asarray(ref_label)), True))
    got_u = tip.combine_fg_mask(got, tip.get_fg_mask(tcfg, torch.from_numpy(ref_label)), True)
    np.testing.assert_array_equal(got_u.numpy(), want_u)
    assert tip.get_fg_mask(face_config(), torch.from_numpy(label)) is None
    assert tip.combine_fg_mask(None, None, False) == 1.0
