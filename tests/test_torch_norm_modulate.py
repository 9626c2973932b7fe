"""The served norms as one pass (fsvid2vid_tpu_torch/ops/norm_modulate.py,
routed from models/layers.py).

The operator fsv::norm_modulate on the CPU is the composition the norms ran
before (addcmul in f32, the result in x's dtype, SPADE's modulations in the
promoted dtype, the leaky ReLU), cast to the dtype the next convolution
reads: autocast's where it is on, else x's; the maps come in that dtype.
The route: an eval-mode norm of a channels-last input with C % 8 == 0 that
autograd does not record is fused; train mode (a training step too),
gradients, NCHW inputs and other channel counts keep the plain
composition, with the outputs they had.  `serving_module` computes each
norm's (scale, shift) once, and the route reuses them only while their
source tensors hold.  A tiny served street and face step gives the plain
route's frames, and the serving export calls the operator once for each
norm the pipeline fuses and serves the pipeline's frames.  The benchmark's
roofline of the operator is counted by hand.  On a CUDA card (marker
`cuda`, skipped without one) the kernel is held against the plain
version.  The file imports neither JAX nor the JAX package and needs no
conftest, so that the card runs it alone:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_norm_modulate.py
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

from fsvid2vid_tpu_torch.config import face_config, street_config
from fsvid2vid_tpu_torch.inference import fold, pipeline
from fsvid2vid_tpu_torch.inference.serve import export_serving, load_serving
from fsvid2vid_tpu_torch.models import build_generator, layers
from fsvid2vid_tpu_torch.ops import norm_modulate as nm
from fsvid2vid_tpu_torch.training import state as tstate
from fsvid2vid_tpu_torch.training import step as tstep

CL = torch.channels_last
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMS, STEPS = 2, 3
# every norm's channels a multiple of 8 (ngf 8: 8, 16, 32, 64)
TINY = dict(ngf=8, nff=8, ndf=8, n_blocks_F=2, n_downsample_G=3, n_adaptive_layers=2,
            batch_size=STREAMS, is_train=False, n_frames_G=2)


@pytest.fixture(autouse=True)
def two_threads():
    """Tiny networks in several pytest workers at once: two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def routes_since(before):
    return {k: v - before[k] for k, v in nm.norm_modulate.calls_by_route.items()}


def operands(n_maps, x_dtype, maps_dtype, c=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (2 * torch.randn(2, c, 5, 7, generator=g) + 0.5).to(x_dtype)
    scale = 0.5 + torch.rand(c, generator=g)
    shift = 0.5 * torch.randn(c, generator=g)
    maps = [(0.3 * torch.randn(2, 2 * c, 5, 7, generator=g)).to(maps_dtype)
            .contiguous(memory_format=CL) for _ in range(n_maps)]
    return x.contiguous(memory_format=CL), scale, shift, maps


@pytest.mark.parametrize("autocast", [False, True])
@pytest.mark.parametrize("slope", [None, 0.2])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_maps", [0, 1, 2, 3])
def test_operator_is_the_plain_composition_in_the_served_dtype(n_maps, x_dtype, slope,
                                                               autocast):
    maps_dtype = torch.bfloat16 if autocast or x_dtype == torch.bfloat16 else torch.float32
    x, scale, shift, maps = operands(n_maps, x_dtype, maps_dtype)
    want = nm.norm_modulate_plain(x, scale, shift, maps, slope)
    before, launches = dict(nm.norm_modulate.calls_by_route), nm.norm_modulate.launches
    with torch.no_grad(), torch.autocast("cpu", torch.bfloat16, enabled=autocast):
        got = nm.norm_modulate(x, scale, shift, maps, slope)
    assert routes_since(before) == {"fused": 1, "plain": 0}
    assert nm.norm_modulate.launches == launches   # the plain version: no kernel
    assert got.dtype == (torch.bfloat16 if autocast else x_dtype)
    assert got.is_contiguous(memory_format=CL) and got.shape == x.shape
    assert torch.equal(got, want.to(got.dtype))


def test_operator_opcheck():
    """Schema, fake tensor and AOT dispatch, with three maps and none."""
    x, scale, shift, maps = operands(3, torch.float32, torch.bfloat16)
    for args in ((x, scale, shift, *maps, 0.2, torch.bfloat16),
                 (x, scale, shift, None, None, None, None, torch.float32)):
        result = torch.library.opcheck(torch.ops.fsv.norm_modulate.default, args)
        assert set(result.values()) == {"SUCCESS"}, result


def test_operator_takes_any_layout_and_refuses_what_the_kernel_does_not_take():
    """A saved program may hand the operator an input laid out otherwise
    than its trace saw: the values are the same and the output is
    channels-last.  C % 8 != 0 and a map of another shape are refused."""
    x, scale, shift, maps = operands(1, torch.float32, torch.float32)
    want = nm.norm_modulate_op(x, scale, shift, *maps, None, None, 0.2, torch.float32)
    got = nm.norm_modulate_op(x.contiguous(), scale, shift, maps[0].contiguous(), None, None,
                              0.2, torch.float32)
    assert got.is_contiguous(memory_format=CL) and torch.equal(got, want)
    x12, scale12, shift12, _ = operands(0, torch.float32, torch.float32, c=12)
    with pytest.raises(ValueError, match="C % 8 == 0"):
        nm.norm_modulate_op(x12, scale12, shift12, None, None, None, None, torch.float32)
    with pytest.raises(ValueError, match="a map must be"):
        nm.norm_modulate_op(x, scale, shift, maps[0][:, :16], None, None, None,
                            torch.float32)


def test_maps_come_in_the_output_dtype_or_the_route_passes_them_by():
    """Every served map is in the dtype the norm hands on (a convolution's
    output under autocast, else the working dtype): the operator refuses
    others, and the route leaves such a call to the plain version."""
    x, scale, shift, maps = operands(1, torch.float32, torch.bfloat16)
    with pytest.raises(ValueError, match="output's dtype"):
        nm.norm_modulate_op(x, scale, shift, *maps, None, None, None, torch.float32)
    assert not nm.fused_route(x, maps)
    with torch.autocast("cpu", torch.bfloat16):
        assert nm.fused_route(x, maps)


# ----------------------------------------------------------------------
# the route
# ----------------------------------------------------------------------
def batch_norm(c, affine, seed=1):
    g = torch.Generator().manual_seed(seed)
    bn = layers.SyncBatchNorm(c, affine=affine)
    with torch.no_grad():
        if affine:
            bn.weight.copy_(1 + 0.3 * torch.randn(c, generator=g))
            bn.bias.copy_(0.3 * torch.randn(c, generator=g))
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(c, generator=g))
        bn.num_batches_tracked.zero_()
    return bn


def parents_norm(bn, x, train):
    """The norm as the parent computed it, then a leaky ReLU of 0.2."""
    x32 = x.float()
    if train:
        var, mean = torch.var_mean(x32, (0, 2, 3), unbiased=False)
    else:
        mean, var = bn.running_mean.float(), bn.running_var.float()
    scale = torch.rsqrt(var + bn.eps)
    if bn.weight is not None:
        scale = scale * bn.weight.float()
    shift = -mean * scale
    if bn.bias is not None:
        shift = shift + bn.bias.float()
    y = torch.addcmul(shift[:, None, None], x32, scale[:, None, None]).to(x.dtype)
    return torch.nn.functional.leaky_relu(y, 0.2)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("case,route", [
    ("served", "fused"),              # eval, channels-last, no gradient
    ("train", "plain"),               # batch statistics
    ("grad", "plain"),                # autograd records the call
    ("nchw", "plain"),
    ("c12", "plain"),                 # C % 8 != 0
])
def test_the_route_follows_the_call(case, route, affine):
    c = 12 if case == "c12" else 16
    bn = batch_norm(c, affine)
    x = torch.randn(2, c, 5, 7, generator=torch.Generator().manual_seed(2))
    xin = x if case == "nchw" else x.contiguous(memory_format=CL)
    if case == "grad":
        xin.requires_grad_(True)
    bn.train(case == "train")
    want = parents_norm(bn, x, train=case == "train")
    before = dict(nm.norm_modulate.calls_by_route)
    with torch.set_grad_enabled(case == "grad"):
        got = bn(xin, slope=0.2)
    assert routes_since(before) == {"fused": int(route == "fused"),
                                    "plain": int(route == "plain")}
    torch.testing.assert_close(got.detach(), want, atol=1e-6, rtol=1e-6)
    if case == "train":
        assert int(bn.num_batches_tracked) == 1
        assert not torch.equal(bn.running_mean, batch_norm(c, affine).running_mean)
    if case == "grad":
        got.sum().backward()
        assert xin.grad is not None and torch.isfinite(xin.grad).all()


def twin(bn, **tensors):
    """A copy of `bn` with some of its tensors replaced."""
    out = copy.deepcopy(bn)
    with torch.no_grad():
        for name, t in tensors.items():
            getattr(out, name).copy_(t)
    return out


@pytest.mark.parametrize("change,reused", [
    (None, True),
    ("in_place", False),          # the statistics edited in place
    ("load_state_dict", False),
    ("deepcopy", False),
    ("train_forward", False),     # a train-mode forward moves the statistics
    ("optimizer", False),         # an update of the affine weight
    # the serving export's trace: the call sees other tensors (its output
    # is held to theirs), the module keeps its own
    ("functional_call", True),
])
def test_serving_module_folds_each_norm_once_while_its_tensors_hold(change, reused):
    """serving_module computes each batch norm's eval (scale, shift) once;
    the fused route reuses them only while the statistics and the affine
    map are the tensors folded, unchanged, and otherwise normalises with
    the tensors it sees."""
    bn = batch_norm(16, affine=True)
    fold.serving_module(torch.nn.Sequential(bn))
    folded = bn._folded[0]
    x = torch.randn(2, 16, 5, 7, generator=torch.Generator().manual_seed(6))
    xin = x.contiguous(memory_format=CL)
    other = batch_norm(16, affine=True, seed=5)
    run = lambda: bn(xin, slope=0.2)
    if change == "in_place":
        with torch.no_grad():
            bn.running_var.mul_(2)
    elif change == "load_state_dict":
        bn.load_state_dict(other.state_dict())
    elif change == "deepcopy":
        bn = copy.deepcopy(bn)
    elif change == "train_forward":
        bn.train()
        bn(x)
        bn.eval()
    elif change == "optimizer":
        bn.weight.grad = torch.ones(16)
        torch.optim.SGD(bn.parameters(), lr=0.1).step()
    elif change == "functional_call":
        swap = {"running_var": other.running_var, "weight": other.weight}
        run = lambda: torch.func.functional_call(bn, swap, (xin,), {"slope": 0.2})
    want_bn = bn if change != "functional_call" else twin(
        bn, running_var=other.running_var, weight=other.weight)
    with torch.no_grad():
        assert (bn._eval_affine()[0] is bn._folded[0]) == reused
        if change in (None, "in_place"):
            assert bn._folded[0] is folded
        before = dict(nm.norm_modulate.calls_by_route)
        got = run()
    assert routes_since(before) == {"fused": 1, "plain": 0}
    torch.testing.assert_close(got, parents_norm(want_bn, x, train=False), atol=1e-6,
                               rtol=1e-6)


def plain_route(monkeypatch):
    monkeypatch.setattr(layers, "fused_route", lambda *a, **k: False)


@pytest.mark.parametrize("n_maps,params_free", [(1, False), (3, False), (1, True)])
def test_spade_and_its_block_fused_equal_plain(n_maps, params_free, monkeypatch):
    """SPADE's norm with its maps, and the residual block's norms with the
    leaky ReLU they feed, in eval on channels-last inputs: one fused call a
    norm, the plain composition's values."""
    torch.manual_seed(3)
    block = layers.SpadeResnetBlock(16, 8, norm="spectralspadesyncbatch3x3",
                                    hidden_ncs=[8] * n_maps, norm_params_free=params_free)
    for m in block.modules():
        if isinstance(m, layers.SyncBatchNorm):
            m.running_mean.normal_()
            m.running_var.uniform_(0.5, 1.5)
        if isinstance(m, layers._SpectralNormed):
            for p in m.parameters():
                torch.nn.init.normal_(p, std=0.2)
            if m.use_sn:
                m.weight_u.normal_()
                m.weight_v.normal_()
        if isinstance(m, torch.nn.Conv2d):
            torch.nn.init.normal_(m.weight, std=0.2)
            torch.nn.init.normal_(m.bias, std=0.1)
    block.eval().to(memory_format=CL)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 16, 6, 8, generator=g).contiguous(memory_format=CL)
    label = [torch.randn(2, 8, 6, 8, generator=g).contiguous(memory_format=CL)
             for _ in range(n_maps)]
    weights = None
    if params_free:   # generated (gamma, beta) kernels of each norm's map 0
        weights = [(torch.randn(2, c, 8, 1, 1, generator=g) * 0.1,
                    torch.randn(2, c, 8, 1, 1, generator=g) * 0.1) for c in (16, 8, 16)]
    before = dict(nm.norm_modulate.calls_by_route)
    with torch.no_grad():
        got = block(x, label, norm_weights=weights)
    assert routes_since(before) == {"fused": 3, "plain": 0}   # bn_s, bn_0, bn_1
    plain_route(monkeypatch)
    with torch.no_grad():
        want = block(x, label, norm_weights=weights)
    assert routes_since(before) == {"fused": 3, "plain": 3}
    assert torch.equal(got, want)


# ----------------------------------------------------------------------
# the served step and the serving export
# ----------------------------------------------------------------------
def cases():
    return {"street_k1": street_config(n_shot=1, fine_size=64, load_size=64, **TINY),
            "face_k3": face_config(n_shot=3, n_downsample_A=2, fine_size=32, load_size=32,
                                   **TINY)}


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


def serve(cfg, compute_dtype):
    """Frames of a reset and STEPS + 1 steps, with the routes they took."""
    torch.manual_seed(0)
    pipe = pipeline.InferencePipeline(cfg, build_generator(cfg, device="cpu"), compute_dtype)
    refs, labels = inputs(cfg)
    before = dict(nm.norm_modulate.calls_by_route)
    pipe.reset(*refs, labels[0])
    frames = [pipe.step(label)["fake_image"] for label in labels]
    return frames, routes_since(before)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["street_k1", "face_k3"])
def test_served_step_fuses_every_norm_and_keeps_its_frames(name, compute_dtype,
                                                           monkeypatch):
    cfg = cases()[name]
    frames, routes = serve(cfg, compute_dtype)
    assert routes["fused"] > 0 and routes["plain"] == 0, routes
    plain_route(monkeypatch)
    want, plain = serve(cfg, compute_dtype)
    assert plain == {"fused": 0, "plain": routes["fused"]}
    # the operator on the CPU is the plain composition; under autocast it
    # rounds to bf16 where the convolution it feeds would
    for t, (a, b) in enumerate(zip(frames, want)):
        assert a.dtype == b.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, err_msg=f"t={t}")


@pytest.mark.parametrize("name", ["street_k1", "face_k3"])
def test_served_steps_reuse_the_folded_norms(name, monkeypatch):
    """Once the pipeline is built (serving_module folds every batch norm),
    its reset and steps compute no norm's (scale, shift) again."""
    cfg = cases()[name]
    torch.manual_seed(0)
    pipe = pipeline.InferencePipeline(cfg, build_generator(cfg, device="cpu"), "bfloat16")
    refs, labels = inputs(cfg)
    computed = []
    monkeypatch.setattr(layers.SyncBatchNorm, "_affine",
                        lambda self, mean, var: computed.append(self))
    before = dict(nm.norm_modulate.calls_by_route)
    pipe.reset(*refs, labels[0])
    for label in labels:
        pipe.step(label)
    assert routes_since(before)["fused"] > 0 and not computed


def test_a_training_step_takes_the_plain_route_only():
    """A temporal training step of a tiny face model whose norms all have
    C % 8 == 0 and whose inputs are channels-last: every norm of G and D
    runs in train mode, none takes the fused route."""
    cfg = face_config(n_shot=1, fine_size=32, load_size=32, **dict(TINY, is_train=True))
    rng = np.random.RandomState(7)
    b, h, w, cl = STREAMS, cfg.height, cfg.width, cfg.gen_input_nc
    mk = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))
    conf = lambda: torch.from_numpy((rng.rand(b, h, w, 1) > 0.3).astype(np.float32))
    batch = dict(tgt_label=mk(b, h, w, cl), tgt_image=torch.tanh(mk(b, h, w, 3)),
                 ref_labels=mk(b, 1, h, w, cl), ref_images=torch.tanh(mk(b, 1, h, w, 3)),
                 flow_gt=[mk(b, h, w, 2), mk(b, h, w, 2)], conf_gt=[conf(), conf()])
    prevs = dict(label=mk(b, h, w, cl), real=torch.tanh(mk(b, h, w, 3)),
                 fake=torch.tanh(mk(b, h, w, 3)))
    torch.manual_seed(0)
    state = tstate.TrainState(cfg, tstate.build_models(cfg, device="cpu"))
    before = dict(nm.norm_modulate.calls_by_route)
    tstep.train_step(cfg, state, batch, prevs, tstep.StepFlags(warp_prev=True, has_prev=True))
    routes = routes_since(before)
    assert routes["fused"] == 0 and routes["plain"] > 0, routes


def test_export_calls_the_operator_and_serves_the_pipelines_frames(tmp_path):
    cfg = cases()["street_k1"]
    torch.manual_seed(0)
    g = build_generator(cfg, device="cpu")
    export_serving(cfg, g, str(tmp_path), dtype=torch.float32)
    for name in ("encode", "step0", "step"):
        ep = torch.export.load(os.path.join(tmp_path, f"{name}.pt2"))
        calls = [n for n in ep.graph.nodes
                 if n.op == "call_function" and "fsv.norm_modulate" in str(n.target)]
        assert calls, f"{name}: no fsv::norm_modulate node"
    refs, labels = inputs(cfg)
    refs, labels = [r[:1] for r in refs], labels[:, :1]   # the programs take one stream
    session = load_serving(str(tmp_path), device="cpu")
    session.reset(*refs, labels[0])
    got = [session.step(label).numpy() for label in labels]
    pipe = pipeline.InferencePipeline(cfg, g)
    pipe.reset(*refs, labels[0])
    want = [pipe.step(label)["fake_image"].numpy() for label in labels]
    for t, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, atol=1e-6, err_msg=f"t={t}")


def test_bf16_export_calls_the_operator_once_for_each_norm_the_pipeline_fuses(tmp_path):
    """The bf16 export (bf16 parameters and inputs, no autocast) fuses the
    same norms as the pipeline: its encode program holds one
    fsv::norm_modulate node for each fused call of a reset, and its step
    programs one for each of a step."""
    cfg = cases()["face_k3"]
    torch.manual_seed(0)
    g = build_generator(cfg, device="cpu")
    export_serving(cfg, g, str(tmp_path), dtype=torch.bfloat16)
    nodes = {}
    for name in ("encode", "step0", "step"):
        ep = torch.export.load(os.path.join(tmp_path, f"{name}.pt2"))
        nodes[name] = sum(1 for n in ep.graph.nodes
                          if n.op == "call_function" and "fsv.norm_modulate" in str(n.target))
    pipe = pipeline.InferencePipeline(cfg, g, "bfloat16")
    refs, labels = inputs(cfg)
    before = dict(nm.norm_modulate.calls_by_route)
    pipe.reset(*refs, labels[0])
    reset = routes_since(before)
    before = dict(nm.norm_modulate.calls_by_route)
    pipe.step(labels[0])
    step = routes_since(before)
    assert reset["plain"] == step["plain"] == 0
    assert nodes == {"encode": reset["fused"], "step0": step["fused"], "step": step["fused"]}


# ----------------------------------------------------------------------
# the benchmark's roofline of the operator
# ----------------------------------------------------------------------
def test_roofline_counts_each_operand_once_by_hand():
    from benchmark.readings import Readings
    from benchmark.registry import Registry
    from benchmark.tracing import HostOp, TraceSummary
    registry = Registry(REPO)
    roof = registry.roofline("norm_modulate")
    peaks = json.loads(open(os.path.join(REPO, "benchmark", "peaks.json")).read())
    # n = 2 * 16 * 5 * 7 = 1120 elements; x f32 4 + out bf16 2 a element,
    # two maps of 2n bf16 elements: 1120 * 6 + 2 * 2240 * 2 = 15680
    assert roof.cost(1120, 2, 4, 2, 2) == 15680
    # recorded shapes: [x, scale, shift, map0, map1, map2, slope, out_dtype]
    shapes = [[2, 16, 5, 7], [16], [16], [2, 32, 5, 7], [], [], [], []]
    assert roof.least_seconds(shapes, 2, peaks) == pytest.approx(
        (1120 * 4 + 2240 * 2) / peaks["bytes_per_s"])
    reader = registry.metric("norm_roofline.serve")
    op = HostOp("fsv::norm_modulate", 0.0, 10.0, False, device_us=4.0, shapes=shapes)
    r = Readings(setup_s=0.0, steps=[], window_start=0.0, window_end=1.0,
                 trace=TraceSummary(window_s=1.0, device=[], host=[op]),
                 peaks=peaks, roofline=registry.roofline)
    assert reader.read(r) == pytest.approx(
        100 * roof.least_seconds(shapes, 2, peaks) / 4e-6)
    r.trace.host = [HostOp("fsv::norm_modulate", 0.0, 10.0, False, device_us=4.0)]
    assert reader.read(r) is None   # a trace without shapes


# ----------------------------------------------------------------------
# the kernel on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the norm kernel runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,maps_dtype,out_dtype,n_maps,slope", [
    (torch.float32, torch.bfloat16, torch.bfloat16, 1, 0.2),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, 3, 0.2),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, 0, None),
    (torch.float32, torch.float32, torch.float32, 2, 0.2),
])
def test_kernel_equals_the_f32_arithmetic_rounded_once(cuda, x_dtype, maps_dtype, out_dtype,
                                                       n_maps, slope):
    """The kernel against the plain version on f32 copies: within half an
    ulp of the output dtype, at a shape with a ragged last block of threads
    and a channel count over 2048."""
    for c, hw in ((24, (7, 9)), (2056, (3, 2))):
        g = torch.Generator().manual_seed(c)
        x = (2 * torch.randn(3, c, *hw, generator=g)).to(x_dtype)
        scale, shift = 0.5 + torch.rand(c, generator=g), torch.randn(c, generator=g)
        maps = [(0.3 * torch.randn(3, 2 * c, *hw, generator=g)).to(maps_dtype)
                for _ in range(n_maps)]
        dev = lambda t: t.to(cuda).contiguous(memory_format=CL) if t.dim() == 4 else t.to(cuda)
        padded = [dev(m) for m in maps] + [None] * (nm.MAX_MAPS - n_maps)
        launches = nm.norm_modulate.launches
        got = nm.norm_modulate_op(dev(x), dev(scale), dev(shift), *padded, slope, out_dtype)
        torch.cuda.synchronize()
        assert nm.norm_modulate.launches == launches + 1
        want = nm.norm_modulate_plain(x.float(), scale, shift, [m.float() for m in maps],
                                      slope)
        rel = 2.0 ** -8 if out_dtype == torch.bfloat16 else 2.0 ** -22
        err = (got.cpu().float() - want).abs()
        assert got.dtype == out_dtype and got.is_contiguous(memory_format=CL)
        assert (err <= rel * want.abs() + 1e-5).all(), err.max()
