"""The served forward in channels-last memory
(fsvid2vid_tpu_torch/inference/fold.py `serving_module`,
inference/pipeline.py `_nchw`).

`batch_conv`'s two routes (ops/batch_conv.py): a channels-last input with a
1 x 1, stride-1 kernel runs as one batched matrix product and equals the
grouped convolution, which every other call keeps.  One
`InferencePipeline.step` of a small street-like K = 1 configuration, of a
small face K = 3 configuration and of a small pose configuration with face
refinement hands every convolution a channels-last input, its frame is a
dense (B, H, W, 3) block, and its frames equal those of the same module run
in NCHW memory, as the pipeline ran before.  The image ops keep a
channels-last layout outside autograd, and a training step's calls keep the
forms they had.  The file imports neither JAX nor the JAX package.
"""
import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from fsvid2vid_tpu_torch.config import face_config, pose_config, street_config
from fsvid2vid_tpu_torch.inference import pipeline
from fsvid2vid_tpu_torch.inference.fold import fold_spectral_norm
from fsvid2vid_tpu_torch.models import build_generator, init_weights
from fsvid2vid_tpu_torch.models.face_refiner import face_refiner_config
from fsvid2vid_tpu_torch.models.generator import FewShotGenerator
from fsvid2vid_tpu_torch.ops.batch_conv import batch_conv
from fsvid2vid_tpu_torch.ops.image_ops import (Upsample, cat_channels, resize_nearest,
                                               upsample_nearest)
from fsvid2vid_tpu_torch.ops.warp import flow_warp

CL = torch.channels_last
STREAMS, STEPS = 2, 3
TINY = dict(ngf=4, nff=4, ndf=4, n_blocks_F=2, n_downsample_G=3, n_adaptive_layers=2,
            compute_dtype="float32", batch_size=STREAMS, is_train=False, n_frames_G=2)
# the serving tests' tolerance on frames (tests/test_torch_street_step.py)
IMG_ATOL = 1e-4


@pytest.fixture(autouse=True)
def two_threads():
    """Tiny networks in several pytest workers at once: two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def routes_since(before):
    return {k: v - before[k] for k, v in batch_conv.calls_by_route.items()}


def per_sample_conv(x, weight, bias, stride):
    """The reference's loop: one conv a sample."""
    k = weight.shape[-1]
    return torch.cat([F.conv2d(x[i:i + 1], weight[i], None if bias is None else bias[i],
                               stride=stride, padding=k // 2)
                      for i in range(x.shape[0])])


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("cin,cout", [(5, 13), (12, 20), (16, 24)])
def test_matmul_route_equals_grouped_route(b, with_bias, cin, cout):
    g = torch.Generator().manual_seed(b * 100 + cin)
    x = torch.randn(b, cin, 6, 10, generator=g)
    weight = torch.randn(b, cout, cin, 1, 1, generator=g)
    bias = torch.randn(b, cout, generator=g) if with_bias else None
    before = dict(batch_conv.calls_by_route)
    grouped = batch_conv(x, weight, bias)
    assert routes_since(before) == {"matmul": 0, "grouped": 1}
    got = batch_conv(x.contiguous(memory_format=CL), weight, bias)
    assert routes_since(before) == {"matmul": 1, "grouped": 1}
    assert got.shape == grouped.shape == (b, cout, 6, 10)
    assert got.is_contiguous(memory_format=CL)
    torch.testing.assert_close(got, grouped, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got, per_sample_conv(x, weight, bias, 1),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("layout,k,stride", [
    ("nchw", 1, 1),
    ("channels_last", 3, 1),   # adaptive_conv's generated 3 x 3 kernels
    ("channels_last", 3, 2),   # the adaptive discriminator's stride-2 calls
    ("channels_last", 1, 2),
    ("channels_last_grad", 1, 1),   # a training step: autograd records it
])
@pytest.mark.parametrize("with_bias", [False, True])
def test_other_calls_keep_the_grouped_route(layout, k, stride, with_bias):
    g = torch.Generator().manual_seed(7)
    b, cin, cout = 3, 5, 6
    x = torch.randn(b, cin, 8, 12, generator=g)
    weight = torch.randn(b, cout, cin, k, k, generator=g)
    bias = torch.randn(b, cout, generator=g) if with_bias else None
    xin = x.contiguous(memory_format=CL) if layout.startswith("channels_last") else x
    if layout == "channels_last_grad":
        xin.requires_grad_(True)
    before = dict(batch_conv.calls_by_route)
    got = batch_conv(xin, weight, bias, stride=stride)
    assert routes_since(before) == {"matmul": 0, "grouped": 1}
    got = got.detach()
    torch.testing.assert_close(got, per_sample_conv(x, weight, bias, stride),
                               atol=1e-5, rtol=1e-5)
    if layout == "nchw":   # bit for bit the grouped conv
        want = F.conv2d(x.reshape(1, b * cin, 8, 12), weight.reshape(b * cout, cin, k, k),
                        stride=stride, padding=k // 2, groups=b).view(b, cout, *got.shape[2:])
        if bias is not None:
            want = want + bias[:, :, None, None]
        assert torch.equal(got, want)


# ----------------------------------------------------------------------
# the served step
# ----------------------------------------------------------------------
CONVS = (torch.ops.aten.convolution.default, torch.ops.aten.conv2d.default)


class ConvInputs(TorchDispatchMode):
    """Records each convolution's input: its shape and whether it is laid out
    channels-last (dense, channels innermost)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in CONVS:
            x = args[0]
            self.seen.append((tuple(x.shape), x.is_contiguous(memory_format=CL)))
        return func(*args, **(kwargs or {}))


def cases():
    street = street_config(n_shot=1, fine_size=64, load_size=64, **TINY)
    face = face_config(n_shot=3, n_downsample_A=2, fine_size=32, load_size=32, **TINY)
    pose = pose_config(n_shot=1, fine_size=128, load_size=128, refine_face=True, **TINY)
    return {"street_k1": street, "face_k3": face, "pose_refine_k1": pose}


def inputs(cfg, seed=1):
    """Reference labels and images, then STEPS + 1 labels, channel-last."""
    rng = np.random.RandomState(seed)
    h, w, k = cfg.height, cfg.width, cfg.n_shot
    if cfg.label_nc:
        label = lambda *s: rng.randint(0, cfg.label_nc, s + (1,)).astype(np.float32)
    else:
        label = lambda *s: rng.randn(*s, cfg.input_nc).astype(np.float32)
    refs = (label(STREAMS, k, h, w),
            np.tanh(rng.randn(STREAMS, k, h, w, 3)).astype(np.float32))
    return refs, label(STEPS + 1, STREAMS, h, w)


def models(cfg):
    torch.manual_seed(0)
    g = build_generator(cfg, device="cpu")
    gf = None
    if cfg.refine_face:
        gf = init_weights(FewShotGenerator(face_refiner_config(cfg), for_face=True),
                          torch.Generator().manual_seed(3), 0.02).eval()
    return g, gf


def nchw_served(net):
    """The pipeline's module as it served before channels-last: folded only."""
    return fold_spectral_norm(net.eval())


def serve(cfg, g, gf):
    """Frames of a reset and STEPS steps, with the convolutions' inputs and
    the batch_conv routes of the steps (not the reset)."""
    pipe = pipeline.InferencePipeline(cfg, g, netGf=gf)
    refs, labels = inputs(cfg)
    pipe.reset(*refs, labels[0])
    frames, seen = [], []
    before = dict(batch_conv.calls_by_route)
    for label in labels[1:]:
        with ConvInputs() as rec:
            out = pipe.step(label)
        frames.append(out["fake_image"])
        seen.append(rec.seen)
        assert torch.equal(pipe.prevs["fake"][..., -3:], out["fake_image"])
    return frames, seen, routes_since(before)


@pytest.mark.parametrize("name", ["street_k1", "face_k3", "pose_refine_k1"])
def test_served_step_is_channels_last_and_equals_nchw(name, monkeypatch):
    cfg = cases()[name]
    g, gf = models(cfg)
    g_nchw, gf_nchw = copy.deepcopy(g), copy.deepcopy(gf)
    frames, seen, routes = serve(cfg, g, gf)
    for t, convs in enumerate(seen, 1):
        assert convs, f"step {t}: no convolution seen"
        nchw = [shape for shape, cl in convs if not cl]
        assert not nchw, f"step {t}: NCHW convolution inputs {nchw}"
    assert routes["matmul"] > 0 and routes["grouped"] == 0, routes
    assert all(p.is_contiguous(memory_format=CL) for p in g.parameters() if p.dim() == 4)
    for frame in frames:   # as tests/test_torch_handoff.py holds it, a dense NHWC block
        assert frame.dtype == torch.float32 and frame.device.type == "cpu"
        assert frame.shape == (STREAMS, cfg.height, cfg.width, 3) and frame.is_contiguous()

    # the same module in NCHW memory: NCHW weights, and inputs copied into
    # NCHW strides (a map of one channel included)
    monkeypatch.setattr(pipeline, "serving_module", nchw_served)
    monkeypatch.setattr(pipeline, "_nchw", lambda x: x.movedim(-1, -3).clone(
        memory_format=torch.contiguous_format))
    want, seen_nchw, routes_nchw = serve(cfg, g_nchw, gf_nchw)
    assert routes_nchw["grouped"] > 0, routes_nchw
    assert not all(cl for shape, cl in seen_nchw[-1])
    for t, (a, b) in enumerate(zip(frames, want), 1):
        assert a.shape == b.shape == (STREAMS, cfg.height, cfg.width, 3)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=IMG_ATOL, err_msg=f"t={t}")


def test_train_mode_forward_keeps_the_grouped_route():
    """A train-mode forward on channels-last views (as training/step.py
    hands the generator its batches): every per-sample convolution is
    recorded by autograd and keeps the grouped route."""
    cfg = cases()["face_k3"].replace(is_train=True)
    g, _ = models(cfg)
    g.train()
    refs, labels = inputs(cfg)
    cl = lambda a: torch.from_numpy(a).movedim(-1, -3)
    before = dict(batch_conv.calls_by_route)
    out = g(cl(labels[0]), cl(refs[0]), cl(refs[1]))
    out["img_final"].mean().backward()
    routes = routes_since(before)
    assert routes["matmul"] == 0 and routes["grouped"] > 0, routes


# ----------------------------------------------------------------------
# the image ops on the served path keep the layout
# ----------------------------------------------------------------------
@pytest.mark.parametrize("size", [(8, 16), (3, 4), (5, 7)])
def test_resize_nearest_keeps_channels_last(size):
    x = torch.randn(2, 6, 5, 7, generator=torch.Generator().manual_seed(1))
    got = resize_nearest(x.contiguous(memory_format=CL), size)
    want = resize_nearest(x, size)
    assert want.is_contiguous() and got.is_contiguous(memory_format=CL)
    assert torch.equal(got, want)


@pytest.mark.parametrize("channels", [3, 6])
def test_flow_warp_keeps_the_image_layout(channels):
    g = torch.Generator().manual_seed(2)
    image = torch.randn(2, channels, 9, 11, generator=g)
    flow = 3 * torch.randn(2, 2, 9, 11, generator=g)
    want = flow_warp(image, flow)
    assert want.is_contiguous()
    # a channels-last image and a slice of its last three channels
    cl = image.contiguous(memory_format=CL)
    got = flow_warp(cl, flow.contiguous(memory_format=CL))
    assert got.is_contiguous(memory_format=CL) and torch.equal(got, want)
    sliced = flow_warp(cl[:, -3:], flow)
    assert sliced.is_contiguous(memory_format=CL)
    assert torch.equal(sliced, flow_warp(image[:, -3:].contiguous(), flow))


def test_cat_channels_keeps_channels_last_beside_a_one_channel_map():
    g = torch.Generator().manual_seed(3)
    image = torch.randn(2, 3, 4, 5, generator=g)
    mask = torch.sigmoid(torch.randn(2, 1, 4, 5, generator=g))   # NCHW strides
    want = torch.cat([image, mask], 1)
    got = cat_channels([image.contiguous(memory_format=CL), mask])
    assert got.is_contiguous(memory_format=CL) and torch.equal(got, want)
    nchw = cat_channels([image, mask])
    assert nchw.is_contiguous() and torch.equal(nchw, want)


@pytest.mark.parametrize("factor", [2, 4])
@pytest.mark.parametrize("autocast", [False, True])
def test_upsample_nearest_keeps_channels_last(factor, autocast):
    """The broadcast copy of a channels-last map equals F.interpolate, in
    its dtype (under autocast, the dtype autocast gives it on the device);
    a map autograd records keeps F.interpolate."""
    x = torch.randn(2, 6, 5, 7, generator=torch.Generator().manual_seed(4))
    if autocast:
        x = x.bfloat16()
    cl = x.contiguous(memory_format=CL)
    with torch.autocast("cpu", torch.bfloat16, enabled=autocast), torch.no_grad():
        want = F.interpolate(x, scale_factor=factor, mode="nearest")
        got = upsample_nearest(cl, factor)
        assert torch.equal(Upsample(factor)(cl), got)
    assert got.dtype == want.dtype
    assert got.is_contiguous(memory_format=CL) and torch.equal(got, want)
    grad = cl.float().requires_grad_(True)
    up = upsample_nearest(grad, factor)
    up.sum().backward()
    assert torch.equal(grad.grad, torch.full_like(grad, float(factor * factor)))


@pytest.mark.parametrize("op", ["flow_warp", "cat_channels", "resize_nearest", "upsample_nearest"])
def test_calls_autograd_records_keep_the_parents_forms(op):
    """A training step's calls (autograd records them) run the forms the
    parent ran, whatever their inputs' layout: the same values with the same
    strides; outside autograd the result is channels-last."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 4, 6, 8, generator=g).contiguous(memory_format=CL).requires_grad_(True)
    flow = torch.randn(2, 2, 6, 8, generator=g)
    ys, xs = torch.tensor([0, 0, 1, 2, 2, 3, 4, 4, 5]), torch.tensor([0, 1, 3, 4, 6])
    calls = {"flow_warp": (lambda: flow_warp(x, flow),
                           lambda: flow_warp(x.contiguous(), flow)),
             "cat_channels": (lambda: cat_channels([x, x[:, :1]]),
                              lambda: torch.cat([x, x[:, :1]], 1)),
             "resize_nearest": (lambda: resize_nearest(x, (9, 5)),
                                lambda: x[:, :, ys][:, :, :, xs]),
             "upsample_nearest": (lambda: upsample_nearest(x),
                                  lambda: F.interpolate(x, scale_factor=2, mode="nearest"))}
    call, parent = calls[op]
    got, want = call(), parent()
    assert got.requires_grad and got.stride() == want.stride() and torch.equal(got, want)
    with torch.no_grad():
        assert call().is_contiguous(memory_format=CL)
