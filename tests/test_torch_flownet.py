"""The port's FlowNet2 and flow teacher against the JAX package, on the CPU.

One set of FlowNet2 parameters is drawn with numpy (`randomize`: kernels
N(0, 1 / fan_in), biases N(0, 0.1)), carried into the port by
`flownet2_state_dict_from_jax` and loaded strictly.  FlowNet2 has no width
knob: it runs whole (162.5 M parameters) at 64 x 64, as tests/test_flownet.py
runs it.  On the CPU both correlations take their plain versions (the JAX
one its XLA reference, as in its own tests).  The fusion net's last layer is
rescaled so that the flow is about half a pixel: the warp then matters and
the confidence is neither all 0 nor all 1.

Tolerance: flows to 1e-3 of the flow's largest magnitude (f32 through some
fifty convolutions summed in another order; the cascade re-warps by its own
flow three times); confidences equal except on at most 0.5 % of the pixels
(the threshold sum(err^2) < 0.02 flips on float noise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.config import face_config as jax_face_config
from fsvid2vid_tpu.models.flownet import flownet2 as jf
from fsvid2vid_tpu.training import flow_teacher as jteacher
from fsvid2vid_tpu_torch.config import face_config
from fsvid2vid_tpu_torch.models.flownet import flownet2 as tf
from fsvid2vid_tpu_torch.training import flow_teacher as tteacher
from fsvid2vid_tpu_torch.utils.convert import flownet2_state_dict_from_jax
from tests.test_torch_layers import randomize, to_numpy

REL_TOL = 1e-3
CONF_MISMATCH = 0.005


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, -3)))


def nhwc(t):
    return t.detach().movedim(-3, -1).numpy()


def smooth_pair(rng, b, h, w, noise):
    """A smooth image in [-1, 1] and a copy shifted by one pixel plus noise."""
    base = rng.randn(b, h // 8 + 2, w // 8 + 2, 3)
    im = np.repeat(np.repeat(base, 8, 1), 8, 2)
    k = np.ones(9) / 9
    for axis in (1, 2):
        im = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), axis, im)
    im1 = np.tanh(im[:, 4:4 + h, 4:4 + w])
    im2 = np.tanh(im[:, 4:4 + h, 5:5 + w]) + noise * rng.randn(b, h, w, 3)
    return im1.astype(np.float32), im2.astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    rng = np.random.RandomState(0)
    jm = jf.FlowNet2()
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, x))
    params = randomize({"params": shapes["params"]}, rng)["params"]
    im1, im2 = smooth_pair(rng, 1, 64, 64, 0.05)
    apply = jax.jit(lambda p, a, b: jm.apply({"params": p}, a, b))
    flow = np.asarray(apply(params, im1, im2))
    last = params["flownetfusion"]["predict_flow0"]
    scale = 0.5 / np.abs(flow).max()
    last["kernel"], last["bias"] = last["kernel"] * scale, last["bias"] * scale
    tm = tf.FlowNet2()
    tm.load_state_dict(flownet2_state_dict_from_jax(to_numpy(params)), strict=True)
    return dict(rng=rng, jm=jm, params=params, tm=tm.eval(), apply=apply,
                pair=(im1, im2))


def assert_flow_close(got, want):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=REL_TOL * scale)


@pytest.mark.parametrize("name,jcls,cin", [
    ("flownetc", jf.FlowNetC, 3), ("flownets_1", jf.FlowNetS, 12),
    ("flownets_d", jf.FlowNetSD, 6), ("flownetfusion", jf.FlowNetFusion, 11)])
def test_subnet_matches_jax(nets, name, jcls, cin):
    rng = nets["rng"]
    xs = [rng.randn(2, 64, 64, cin).astype(np.float32)
          for _ in range(2 if name == "flownetc" else 1)]
    want = np.asarray(jcls().apply({"params": nets["params"][name]},
                                   *map(jnp.asarray, xs)))
    with torch.no_grad():
        got = nhwc(getattr(nets["tm"], name)(*map(nchw, xs)))
    assert got.shape == want.shape
    assert_flow_close(got, want)


def test_flownet2_matches_jax(nets):
    im1, im2 = nets["pair"]
    want = np.asarray(nets["apply"](nets["params"], im1, im2))
    with torch.no_grad():
        got = nhwc(nets["tm"](nchw(im1), nchw(im2)))
    assert got.shape == (1, 64, 64, 2)
    assert 0.45 < np.abs(want).max() < 0.55     # the fixture's rescaling
    assert_flow_close(got, want)


@pytest.mark.parametrize("name,count", [
    ("flownetc", 39_175_298), ("flownets_1", 38_695_322),
    ("flownets_2", 38_695_322), ("flownets_d", 45_371_666),
    ("flownetfusion", 581_226), (None, 162_518_834)])
def test_param_counts(name, count):
    """The counts tests/test_flownet.py asserts of the JAX modules."""
    with torch.device("meta"):
        net = tf.FlowNet2()
    net = getattr(net, name) if name else net
    assert sum(p.numel() for p in net.parameters()) == count


def test_state_dict_has_the_reference_checkpoint_names(nets):
    sd = nets["tm"].state_dict()
    for key, shape in [("flownetc.conv1.0.weight", (64, 3, 7, 7)),
                       ("flownetc.conv_redir.0.bias", (32,)),
                       ("flownetc.upsampled_flow6_to_5.bias", (2,)),
                       ("flownets_1.deconv5.0.weight", (1024, 512, 4, 4)),
                       ("flownets_2.upsampled_flow3_to_2.weight", (2, 2, 4, 4)),
                       ("flownets_d.inter_conv5.0.weight", (512, 1026, 3, 3)),
                       ("flownetfusion.predict_flow0.weight", (2, 16, 3, 3))]:
        assert tuple(sd[key].shape) == shape, key
    assert "flownets_1.upsampled_flow6_to_5.bias" not in sd   # bias-free in FlowNetS


def test_compute_flow_and_conf_at_a_size_that_is_no_multiple_of_64(nets):
    """72 x 80 is shrunk to 64 x 64 (antialiased, as jax.image.resize does),
    and the flow enlarged back and scaled by h / nh."""
    im1, im2 = smooth_pair(nets["rng"], 2, 72, 80, 0.05)
    jflow, jconf = jteacher.compute_flow_and_conf(
        nets["jm"], nets["params"], jnp.asarray(im1), jnp.asarray(im2))
    flow, conf = tteacher.compute_flow_and_conf(nets["tm"], nchw(im1), nchw(im2))
    assert flow.shape == (2, 2, 72, 80) and conf.shape == (2, 1, 72, 80)
    assert flow.dtype == conf.dtype == torch.float32 and not flow.requires_grad
    assert_flow_close(nhwc(flow), np.asarray(jflow))
    jconf = np.asarray(jconf)
    assert 0.05 < jconf.mean() < 0.95, "degenerate confidence"
    assert (np.abs(nhwc(conf) - jconf) > 1e-3).mean() <= CONF_MISMATCH


def test_flow_teacher_in_both_phases(nets):
    """The shapes tests/test_flownet.py asserts of the JAX teacher, and its
    values."""
    cfg = face_config(fine_size=64, load_size=64)
    jcfg = jax_face_config(fine_size=64, load_size=64)
    im1, im2 = smooth_pair(nets["rng"], 1, 64, 64, 0.05)
    ref, _ = smooth_pair(nets["rng"], 1, 64, 64, 0.05)
    seq = {"tgt_label": np.zeros((1, 2, 64, 64, 1), np.float32),
           "tgt_image": np.stack([im1, im2], 1),
           "ref_labels": np.zeros((1, 1, 64, 64, 1), np.float32),
           "ref_images": (0.7 * im1 + 0.3 * ref)[:, None]}
    jt = jteacher.FlowTeacher(jcfg, params=nets["params"])
    tt = tteacher.FlowTeacher(cfg, device="cpu",
                              state_dict=nets["tm"].state_dict())
    tseq = {k: torch.from_numpy(v) for k, v in seq.items()}
    epoch = cfg.niter_single + 1
    jflow, jconf = jt(jcfg, seq, epoch)
    flow, conf = tt(cfg, tseq, epoch)
    for i in range(2):
        assert tuple(flow[i].shape) == (1, 2, 64, 64, 2)
        assert tuple(conf[i].shape) == (1, 2, 64, 64, 1)
        assert_flow_close(flow[i].numpy(), np.asarray(jflow[i]))
        assert (np.abs(conf[i].numpy() - np.asarray(jconf[i])) > 1e-3).mean() \
            <= CONF_MISMATCH
    # before the temporal phase: the reference flow only
    flow1, conf1 = tt(cfg, tseq, epoch=1)
    assert flow1[1] is None and conf1[1] is None
    torch.testing.assert_close(flow1[0], flow[0])


def test_teacher_is_frozen_and_seeded():
    """Built from a seed, the teacher has the same weights on every build,
    takes no gradient, and needs a card unless the caller asks for the CPU."""
    cfg = face_config()
    a = tteacher.FlowTeacher(cfg, device="cpu")
    b = tteacher.FlowTeacher(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(cfg.seed))
    assert not any(p.requires_grad for p in a.model.parameters())
    assert not a.model.training
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tteacher.FlowTeacher(cfg)
