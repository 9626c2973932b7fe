"""Train mode of the port's layers and generator against flax, on the CPU.

Variables are drawn with numpy (`randomize`) and carried across by
`state_dict_from_jax`; spectral u / v are then replaced by random unit
vectors, so that a power iteration really moves them.  The JAX modules run
with train=True and their mutated collections ("spectral", "batch_stats")
are compared with the port's buffers after the same forward.

Tolerances: layer outputs and gradients 1e-4 and new u / v and running
statistics 1e-5 (the same f32 arithmetic summed in another order); generator
images 1e-4, flows 2e-3 (scaled by flow_multiplier = 20), warped images 1e-3
(a noise image, whose slope is up to 2 per pixel, sampled at positions that
agree to the flows' 2e-3 pixels), its new u / v and batch statistics 1e-5.  The JAX generator keeps its space-to-depth train
layout on the two finest levels (exact math); the port runs the plain layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.models import layers as jl
from fsvid2vid_tpu.models.generator import FewShotGenerator as JaxGenerator
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.inference.fold import fold_spectral_norm
from fsvid2vid_tpu_torch.models import build_generator
from fsvid2vid_tpu_torch.models import layers as tl
from fsvid2vid_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_networks import tiny_face_cfg
from tests.test_torch_layers import randomize, to_numpy

ATOL = 1e-4
STATE_ATOL = 1e-5
FLOW_ATOL = 2e-3
WARP_ATOL = 1e-3


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, -3)))


def nhwc(t):
    return t.detach().movedim(-3, -1).numpy()


def random_uv(variables, rng):
    unit = lambda a: jnp.asarray((lambda r: r / np.linalg.norm(r))(
        rng.randn(*a.shape)).astype(np.float32))
    return dict(variables, spectral=jax.tree_util.tree_map(unit, variables["spectral"]))


def assert_state_matches(module, variables, mutated, cfg=None):
    """The port module's parameters and buffers against the JAX variables
    with the mutated collections put in."""
    want = state_dict_from_jax(to_numpy(dict(variables, **mutated)),
                               cfg or tconfig.face_config())
    got = module.state_dict()
    assert set(got) == set(want)
    for key, value in got.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                       atol=STATE_ATOL, err_msg=key)


# ----------------------------------------------------------------------
# spectral-norm conv / linear
# ----------------------------------------------------------------------
@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("kind", ["conv", "conv_stride2", "linear"])
def test_sn_layer_train_forward(rng, kind, iters):
    """Output, gradients w.r.t. input and weight (sigma is differentiable
    through W only), and the advanced u / v."""
    from fsvid2vid_tpu.ops import spectral_norm as jsn
    if kind == "linear":
        x = rng.randn(6, 11).astype(np.float32)
        jm, tm = jl.SNDense(9), tl.SNLinear(11, 9)
        to_t, from_t = torch.from_numpy, lambda t: t.detach().numpy()
    else:
        stride = 2 if kind == "conv_stride2" else 1
        x = rng.randn(2, 9, 10, 5).astype(np.float32)
        jm, tm = jl.SNConv(7, 3, stride), tl.SNConv(5, 7, 3, stride)
        to_t, from_t = nchw, nhwc
    v = random_uv(randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng), rng)
    tm.load_state_dict(state_dict_from_jax(to_numpy(v), tconfig.face_config()),
                       strict=True)
    tm.power_iters = iters
    u0 = tm.weight_u.clone()

    def loss(params, xin):
        out, mut = jm.apply(dict(v, params=params), xin, train=True,
                            mutable=["spectral"])
        return (out * cot).sum(), (out, mut)

    jsn.set_power_iters(iters)
    try:
        out0 = jm.apply(v, jnp.asarray(x), train=False)
        cot = jnp.asarray(rng.randn(*out0.shape).astype(np.float32))
        (_, (want, mut)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    finally:
        jsn.set_power_iters(1)

    xt = to_t(x).requires_grad_()
    got = tm.train()(xt)
    (got * to_t(np.array(cot))).sum().backward()
    np.testing.assert_allclose(from_t(got), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(from_t(xt.grad), np.asarray(gx), atol=ATOL)
    grads = state_dict_from_jax({"params": to_numpy(gp)}, tconfig.face_config())
    np.testing.assert_allclose(tm.weight_orig.grad.numpy(), grads["weight"].numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(tm.bias.grad.numpy(), grads["bias"].numpy(), atol=ATOL)
    assert_state_matches(tm, v, mut)
    assert (tm.weight_u - u0).abs().max() > 1e-2
    # eval leaves u / v alone
    u1 = tm.weight_u.clone()
    tm.eval()(to_t(x))
    assert torch.equal(tm.weight_u, u1)


@pytest.mark.parametrize("make", [lambda: tl.SNConv(4, 6, 3), lambda: tl.SNLinear(4, 6)])
def test_folded_layer_refuses_a_train_forward(rng, make):
    """Folded serving weights can never be trained nor have u / v advanced."""
    m = make()
    with torch.no_grad():
        for p in list(m.parameters()) + list(m.buffers()):
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    x = torch.zeros(2, 4, 8, 8) if isinstance(m, tl.SNConv) else torch.zeros(2, 4)
    fold_spectral_norm(m.eval())
    assert m.folded
    u = m.weight_u.clone()
    m(x)                                    # eval forward still serves
    with pytest.raises(RuntimeError, match="folded"):
        m.train()(x)
    assert torch.equal(m.weight_u, u)


# ----------------------------------------------------------------------
# batch norm
# ----------------------------------------------------------------------
@pytest.mark.parametrize("affine", [True, False])
def test_sync_batch_norm_train_forward(rng, affine):
    """Batch statistics over (B, H, W), running stats with momentum 0.1 and
    the unbiased variance, gradients through the statistics."""
    x = (2 * rng.randn(3, 6, 7, 5) + 0.5).astype(np.float32)
    jm = jl.SyncBatchNorm(5, affine=affine)
    v = randomize(dict({"params": {}}, **jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    cot = rng.randn(*x.shape).astype(np.float32)

    def loss(params, xin):
        out, mut = jm.apply(dict(v, params=params), xin, train=True,
                            mutable=["batch_stats"])
        return (out * jnp.asarray(cot)).sum(), (out, mut)

    (_, (want, mut)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    tm = tl.SyncBatchNorm(5, affine=affine)
    tm.load_state_dict(state_dict_from_jax(to_numpy(v), tconfig.face_config()),
                       strict=True)
    xt = nchw(x).requires_grad_()
    got = tm.train()(xt)
    (got * nchw(cot)).sum().backward()
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(gx), atol=ATOL)
    if affine:
        np.testing.assert_allclose(tm.weight.grad.numpy(), np.asarray(gp["scale"]), atol=ATOL)
        np.testing.assert_allclose(tm.bias.grad.numpy(), np.asarray(gp["bias"]), atol=ATOL)
    assert_state_matches(tm, v, mut)
    assert int(tm.num_batches_tracked) == 1
    n = 3 * 6 * 7
    want_var = 0.9 * np.asarray(v["batch_stats"]["var"]) + 0.1 * x.var((0, 1, 2)) * n / (n - 1)
    np.testing.assert_allclose(tm.running_var.numpy(), want_var, atol=STATE_ATOL)


@pytest.mark.parametrize("fin,fout,norm,n_maps", [
    (8, 6, "spectralspadesyncbatch", 3), (6, 6, "spectralsyncbatch", 0)])
def test_spade_resnet_block_train_forward(rng, fin, fout, norm, n_maps):
    b = 2
    x = rng.randn(b, 8, 8, fin).astype(np.float32)
    maps = [rng.randn(b, 16, 16, 4).astype(np.float32) for _ in range(n_maps)]
    hidden = [4] * n_maps if n_maps else (0,)
    jm = jl.SpadeResnetBlock(fin, fout, norm=norm, hidden_ncs=hidden)
    jlabel = [jnp.asarray(m) for m in maps] if n_maps else None
    v = random_uv(randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jlabel),
                            rng), rng)
    want, mut = jm.apply(v, jnp.asarray(x), jlabel, train=True,
                         mutable=["spectral", "batch_stats"])
    tm = tl.SpadeResnetBlock(fin, fout, norm, hidden)
    tm.load_state_dict(state_dict_from_jax(to_numpy(v), tconfig.face_config()),
                       strict=True)
    got = tm.train()(nchw(x), [nchw(m) for m in maps] if n_maps else None)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)
    assert_state_matches(tm, v, mut)


# ----------------------------------------------------------------------
# the generator's train forward
# ----------------------------------------------------------------------
_GEN_PAIRS = {}


def gen_pair(add_raw):
    if add_raw not in _GEN_PAIRS:
        _GEN_PAIRS[add_raw] = _make_gen_pair(add_raw)
    return _GEN_PAIRS[add_raw]


def _make_gen_pair(add_raw):
    rng = np.random.RandomState(3)
    cfg = tiny_face_cfg(n_shot=1, batch_size=2, add_raw_output_loss=add_raw)
    b, h, w, cl = 2, cfg.height, cfg.width, cfg.gen_input_nc
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    inputs = dict(label=mk(b, h, w, cl), ref_labels=mk(b, 1, h, w, cl),
                  ref_images=np.tanh(mk(b, 1, h, w, 3)), prev_label=mk(b, h, w, cl),
                  prev_image=np.tanh(mk(b, h, w, 3)))
    jm = JaxGenerator(cfg)
    args = [jnp.asarray(inputs[k]) for k in
            ("label", "ref_labels", "ref_images", "prev_label", "prev_image")]
    shapes = jax.eval_shape(lambda *a: jm.init(*a, warp_prev=True, train=True),
                            jax.random.PRNGKey(0), *args)
    variables = random_uv(randomize(shapes, rng), rng)
    tcfg = tconfig.Config.from_json(cfg.to_json())
    return cfg, tcfg, jm, variables, inputs


@pytest.mark.parametrize("warp_prev,add_raw", [(False, False), (True, False),
                                               (True, True)])
def test_generator_train_forward(warp_prev, add_raw):
    """With add_raw_output_loss the up blocks of the combine levels run twice
    per forward (raw first), so their u / v and batch statistics advance
    twice; the shared flow network runs twice when warp_prev."""
    cfg, tcfg, jm, variables, inp = gen_pair(add_raw)
    prev = (inp["prev_label"], inp["prev_image"]) if warp_prev else (None, None)
    jprev = [None if p is None else jnp.asarray(p) for p in prev]
    want, mut = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(inp["label"]), jnp.asarray(inp["ref_labels"]),
        jnp.asarray(inp["ref_images"]), *jprev, warp_prev=warp_prev, train=True,
        mutable=["spectral", "batch_stats"]))(variables)
    g = build_generator(tcfg, device="cpu")
    g.load_state_dict(state_dict_from_jax(to_numpy(variables), tcfg), strict=True)
    before = {k: v.clone() for k, v in g.state_dict().items()}
    tprev = [None if p is None else nchw(p) for p in prev]
    got = g.train()(nchw(inp["label"]), nchw(inp["ref_labels"]),
                    nchw(inp["ref_images"]), *tprev, warp_prev=warp_prev)
    assert got["img_final"].requires_grad
    np.testing.assert_allclose(nhwc(got["img_final"]), np.asarray(want["img_final"]),
                               atol=ATOL)
    if add_raw:
        np.testing.assert_allclose(nhwc(got["img_raw"]), np.asarray(want["img_raw"]),
                                   atol=ATOL)
    else:
        assert got["img_raw"] is None and want["img_raw"] is None
    n_flows = 2 if warp_prev else 1
    for i in range(2):
        for key, atol in (("flow", FLOW_ATOL), ("flow_mask", ATOL), ("img_warp", WARP_ATOL)):
            if i < n_flows:
                np.testing.assert_allclose(nhwc(got[key][i]), np.asarray(want[key][i]),
                                           atol=atol, err_msg=f"{key}[{i}]")
            else:
                assert got[key][i] is None and want[key][i] is None
    assert np.abs(np.asarray(want["flow"][0])).max() > 1.0
    assert got["ref_idx"] is None and want["ref_idx"] is None
    assert_state_matches(g, variables, mut, tcfg)
    after = g.state_dict()
    moved = [k for k in after if k.endswith("weight_u")
             and (after[k] - before[k]).abs().max() > 1e-3]
    assert any(k.startswith("flow_network_ref.") for k in moved)
    assert any(k.startswith("up_0.") for k in moved)
    # a module that only the temporal phase runs stays put without it
    emb_moved = (after["img_prev_embedding.conv_first.0.weight"]
                 - before["img_prev_embedding.conv_first.0.weight"]).abs().max() > 0
    assert not emb_moved


def test_generator_train_mode_limits():
    """The serving caches are built at eval only (train mode at K > 1 runs
    the full forward: tests/test_torch_generator_train_k3.py)."""
    cfg = tconfig.face_config(ngf=4, nff=4, fine_size=32, load_size=32,
                              n_downsample_G=3, n_adaptive_layers=2, n_shot=2)
    g = build_generator(cfg, device="cpu").train()
    refs_l = torch.zeros(1, 2, cfg.gen_input_nc, 32, 32)
    refs_i = torch.zeros(1, 2, 3, 32, 32)
    with pytest.raises(NotImplementedError, match="eval"):
        g.encode_reference_multi(refs_l, refs_i)
