"""The port's FlowNet2 sub-variants (FlowNet2C, 2S, 2SD, 2CS, 2CSS) against
the JAX modules, on the CPU.

Each variant's parameters are drawn with numpy (`randomize`), carried into
the port by `flownet2_state_dict_from_jax` and loaded strictly, then both
run at 64 x 64 on frames in [0, 1].  Where a stage's flow feeds a warp (the
C stage of 2CS and 2CSS, the first S stage of 2CSS), its predict_flow2 is
rescaled so that the flow is a few pixels: the warp then moves pixels
without running off the frame.  On the CPU both correlations take their
plain versions.

Tolerance: tests/test_torch_flownet.py's, flows to 1e-3 of the flow's
largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.models.flownet import flownet2 as jf
from fsvid2vid_tpu_torch.models.flownet import flownet2 as tf
from fsvid2vid_tpu_torch.ops.image_ops import upsample_nearest
from fsvid2vid_tpu_torch.utils.convert import flownet2_state_dict_from_jax
from tests.test_torch_flownet import assert_flow_close, nchw, nhwc, smooth_pair
from tests.test_torch_layers import randomize, to_numpy

NAMES = ("FlowNet2C", "FlowNet2S", "FlowNet2SD", "FlowNet2CS", "FlowNet2CSS")
# stages whose flow is warped by the next one, scaled to about this many pixels
WARPED_STAGES = {"FlowNet2CS": [("flownetc", "FlowNet2C")],
                 "FlowNet2CSS": [("flownetc", "FlowNet2C"), ("flownets_1", "FlowNet2CS")]}
FLOW_PIXELS = 3.0


def _apply(name, params, im1, im2):
    return np.asarray(getattr(jf, name)().apply({"params": params}, im1, im2))


@pytest.fixture(scope="module")
def pair():
    im1, im2 = smooth_pair(np.random.RandomState(1), 2, 64, 64, 0.05)
    return (im1 + 1) / 2, (im2 + 1) / 2


@pytest.fixture(scope="module")
def variants(pair):
    """name -> (JAX params, the port's module loaded from them)."""
    rng = np.random.RandomState(0)
    x = jnp.zeros((1, 64, 64, 3))
    out = {}
    for name in NAMES:
        shapes = jax.eval_shape(lambda: getattr(jf, name)().init(jax.random.PRNGKey(0), x, x))
        params = to_numpy(randomize({"params": shapes["params"]}, rng)["params"])
        for stage, upto in WARPED_STAGES.get(name, []):
            stages = ("flownetc",) if upto == "FlowNet2C" else ("flownetc", "flownets_1")
            flow = _apply(upto, {k: params[k] for k in stages}, *pair)
            last = params[stage]["predict_flow2"]
            scale = FLOW_PIXELS / np.abs(flow).max()
            last["kernel"], last["bias"] = last["kernel"] * scale, last["bias"] * scale
        net = getattr(tf, name)()
        net.load_state_dict(flownet2_state_dict_from_jax(params), strict=True)
        out[name] = params, net.eval()
    return out


@pytest.mark.parametrize("name", NAMES)
def test_variant_matches_jax(variants, pair, name):
    params, net = variants[name]
    want = _apply(name, params, *pair)
    with torch.no_grad():
        got = nhwc(net(*map(nchw, pair)))
    assert got.shape == want.shape == (2, 64, 64, 2)
    assert_flow_close(got, want)
    if name in WARPED_STAGES:   # the first stage's flow moves pixels, inside the frame
        with torch.no_grad():
            c_flow = tf.FlowNet2C.forward(net, *map(nchw, pair))
        assert 0.5 * FLOW_PIXELS < c_flow.abs().max() < 2 * FLOW_PIXELS


def test_css_head_is_nearest_and_the_cs_head_bilinear(variants, pair):
    """FlowNet2CSS's last x4 upsampling is nearest (reference upsample3):
    every 4 x 4 block of its flow is one value; FlowNet2CS's is not."""
    x1, x2 = map(nchw, pair)
    with torch.no_grad():
        css = variants["FlowNet2CSS"][1](x1, x2)
        cs = variants["FlowNet2CS"][1](x1, x2)
    assert torch.equal(css, upsample_nearest(css[..., ::4, ::4], 4))
    assert not torch.allclose(cs, upsample_nearest(cs[..., ::4, ::4], 4), atol=1e-3)


@pytest.mark.parametrize("name", NAMES)
def test_param_counts_match_jax(name):
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda: getattr(jf, name)().init(jax.random.PRNGKey(0), x, x))
    want = sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        net = getattr(tf, name)()
    assert sum(p.numel() for p in net.parameters()) == want


@pytest.mark.parametrize("name", ["FlowNet2C", "FlowNet2CS", "FlowNet2CSS"])
def test_strict_load_from_a_flownet2_state_dict(name):
    """The cascade's `flownetc.*` and `flownets_1.*` / `flownets_2.*` keys
    are the variant's own: its keys are a subset of FlowNet2's, and a
    strict load of that subset carries every tensor."""
    torch.manual_seed(0)
    full = tf.FlowNet2().state_dict()
    net = getattr(tf, name)()
    keys = set(net.state_dict())
    assert keys <= set(full)
    net.load_state_dict({k: full[k] for k in keys}, strict=True)
    for k, v in net.state_dict().items():
        assert torch.equal(v, full[k]), k
