"""The port's generator in train mode at K = 3 against the JAX package's, on
the CPU in f32: the differentiable K > 1 attention
(`chunked_ref_attention`, the JAX module's non-flash branch,
fsvid2vid_tpu/models/generator.py:306-340) inside the whole forward.

Both generators hold one set of numpy-drawn variables (`randomize`, spectral
u / v random unit vectors) at tests/test_torch_train_step.py's size (ngf 4,
32 px, three downsamplings, two adaptive layers, batch 2) and split the
attention's 64 queries into 4 chunks (atn_chunk_elems = 192 x 16: 3
references x 8 x 8 keys).  At 64 px with five downsamplings the batch
statistics of the 2 x 2 bottleneck make the gradients ill-conditioned in
f32, so that two f32 computations of them (JAX's own f32 and f64 among
them) part by percents per tensor; at this size they agree to about the
tolerance below, least in the shared flow network's first batch norm when
it runs twice (warp_prev).  So the forward here is the single-frame one
(no previous frames), whose flow network runs once; the temporal step at
K = 3 is held against JAX in tests/test_torch_train_step_k3.py.

Tolerances:
  * images 1e-4, flows 2e-3 (flow_multiplier 20 x 1e-4), masks 1e-4, warped
    images 1e-3, new u / v and batch statistics 1e-5 (the tolerances of
    tests/test_torch_train_layers.py, the same f32 arithmetic summed in
    another order);
  * the gradient of a fixed random projection of img_final with respect to
    every G parameter: per tensor, |g_port - g_jax| <= 1e-4 |g_jax| in the
    2-norm, plus a floor of 1e-6 of the largest tensor norm for tensors whose
    true gradient is zero and hold rounding noise only (a conv bias that a
    norm layer removes);
  * ref_idx, the argmax of each sample's attention masses: compared only
    where JAX's top two masses differ by more than 100 times their
    tolerance (hw x 1e-5, tests/test_torch_generator.py), so that a flip
    would be a real gap and not rounding; the test asserts that every
    sample here clears that margin, since a sample that did not could warp
    another reference and its images could not be compared either;
  * `chunked_ref_attention` alone: the same outputs, masses and input
    gradients at 1, 4 and 16 chunks, to 1e-6 of each tensor's largest
    magnitude (f32 sums of 192 products in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.models.generator import FewShotGenerator as JaxGenerator
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.models import build_generator
from fsvid2vid_tpu_torch.ops.attention_kernel import (
    chunked_ref_attention, flash_ref_attention_plain)
from fsvid2vid_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_networks import tiny_face_cfg
from tests.test_torch_layers import randomize, to_numpy
from tests.test_torch_train_layers import (
    assert_state_matches, nchw, nhwc, random_uv)

K, B = 3, 2
TINY = dict(fine_size=32, load_size=32, n_downsample_G=3, n_adaptive_layers=2)
HW = 8 * 8                    # the attention's map: 32 px / 2^n_downsample_A
CHUNK_ELEMS = K * HW * 16     # 4 query chunks of 16
IMG_ATOL, FLOW_ATOL, WARP_ATOL = 1e-4, 2e-3, 1e-3
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-6
MASS_ATOL = HW * 1e-5
INPUTS = ("label", "ref_labels", "ref_images", "prev_label", "prev_image")


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(8)
    cfg = tiny_face_cfg(n_shot=K, batch_size=B, **TINY)
    h, w, cl = cfg.height, cfg.width, cfg.gen_input_nc
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    inputs = dict(label=mk(B, h, w, cl), ref_labels=mk(B, K, h, w, cl),
                  ref_images=np.tanh(mk(B, K, h, w, 3)), prev_label=mk(B, h, w, cl),
                  prev_image=np.tanh(mk(B, h, w, 3)))
    jm = JaxGenerator(cfg, atn_chunk_elems=CHUNK_ELEMS)
    args = [jnp.asarray(inputs[k]) for k in INPUTS]
    shapes = jax.eval_shape(lambda *a: jm.init(*a, warp_prev=True, train=True),
                            jax.random.PRNGKey(0), *args)
    variables = random_uv(randomize(shapes, rng), rng)
    proj = mk(B, h, w, 3)
    aux = {c: v for c, v in variables.items() if c != "params"}

    def loss(params):
        out, mut = jm.apply(dict(aux, params=params), *args[:3], warp_prev=False, train=True,
                            mutable=["spectral", "batch_stats"])
        return (out["img_final"] * proj).sum(), (out, mut)

    (_, (want, mut)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    masses = jax.jit(lambda v: jm.apply(
        v, args[2], args[1], args[0], train=True, mutable=["spectral", "batch_stats"],
        method=lambda m, i, l, x, train: m.weight_generation(i, l, x, train=train)
    )[0][1]["atn"])(variables)

    tcfg = tconfig.Config.from_json(cfg.to_json())
    g = build_generator(tcfg, device="cpu")
    g.load_state_dict(state_dict_from_jax(to_numpy(variables), tcfg), strict=True)
    g.atn_chunk_elems = CHUNK_ELEMS
    g.attention = _b1_refused    # train mode must never reach B1
    got = g.train()(*[nchw(inputs[k]) for k in INPUTS[:3]], warp_prev=False)
    (got["img_final"] * nchw(proj)).sum().backward()
    return dict(cfg=cfg, tcfg=tcfg, g=g, got=got, want=want, mut=mut,
                variables=variables, grads=grads, masses=np.asarray(masses))


def _b1_refused(*args):
    raise AssertionError("B1 was called in train mode")


def test_outputs_and_mutated_state_match_jax(pair):
    got, want = pair["got"], pair["want"]
    assert got["img_final"].requires_grad
    np.testing.assert_allclose(nhwc(got["img_final"]), np.asarray(want["img_final"]),
                               atol=IMG_ATOL)
    assert np.asarray(want["img_final"]).std() > 0.02
    for key, atol in (("flow", FLOW_ATOL), ("flow_mask", IMG_ATOL),
                      ("img_warp", WARP_ATOL)):
        np.testing.assert_allclose(nhwc(got[key][0]), np.asarray(want[key][0]),
                                   atol=atol, err_msg=key)
        assert got[key][1] is None and want[key][1] is None
    np.testing.assert_allclose(got["atn_vis"].detach().numpy(),
                               np.asarray(want["atn_vis"]), atol=1e-5)
    # the key encoder's u / v and batch statistics advanced over the B·K
    # references, the query encoder's over the B targets, as JAX's
    assert_state_matches(pair["g"], pair["variables"], pair["mut"], pair["tcfg"])


def test_ref_idx_matches_jax_where_the_masses_are_apart(pair):
    masses, got = pair["masses"], pair["got"]
    assert masses.shape == (B, K)
    np.testing.assert_allclose(masses.sum(1), HW, rtol=1e-5)
    top2 = np.sort(masses, 1)[:, -2:]
    decisive = top2[:, 1] - top2[:, 0] > 100 * MASS_ATOL
    assert decisive.all(), top2
    want = np.asarray(pair["want"]["ref_idx"])
    assert got["ref_idx"].tolist() == want.tolist() == np.argmax(masses, 1).tolist()


def test_gradients_of_every_g_parameter_match_jax(pair):
    g = pair["g"]
    aux = {c: v for c, v in pair["variables"].items() if c != "params"}
    want = state_dict_from_jax(to_numpy(dict(aux, params=pair["grads"])), pair["tcfg"])
    params = dict(g.named_parameters())
    norms = {n: float(np.linalg.norm(want[n].numpy())) for n in params}
    floor = GRAD_FLOOR * max(norms.values())
    checked = 0
    for name, p in params.items():
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        diff = float(np.linalg.norm(grad.numpy() - want[name].numpy()))
        assert diff <= GRAD_RTOL * norms[name] + floor, (name, diff, norms[name])
        checked += norms[name] > 100 * floor
    # the attention's encoders learn through the chunked softmax
    for prefix in ("atn_key_first.", "atn_query_first.", "atn_key_1.", "atn_query_1."):
        assert any(norms[n] > 100 * floor for n in params if n.startswith(prefix)), prefix
    assert checked > 100


def test_eval_runs_b1_and_train_mode_does_not(pair):
    """The routing is the JAX rule, `use_flash = not train and ...`: eval
    calls the generator's B1 (here a recorder around its plain version),
    train mode the chunked path only."""
    g, cfg = pair["g"], pair["cfg"]
    calls = []

    def recorded(*args):
        calls.append(args[0].shape)
        return flash_ref_attention_plain(*args)
    h, w, cl = cfg.height, cfg.width, cfg.gen_input_nc
    x = torch.randn(1, cl, h, w)
    refs = torch.randn(1, K, cl, h, w), torch.tanh(torch.randn(1, K, 3, h, w))
    g.attention = recorded
    try:
        with torch.no_grad():
            state = {k: v.clone() for k, v in g.state_dict().items()}
            g.train()(x, *refs)
            assert calls == []
            g.eval()(x, *refs)
            assert calls == [(1, HW, cfg.ngf * 4)]
            g.load_state_dict(state)
    finally:
        g.attention = _b1_refused


def attention_inputs(seed, b=2, hw=64, k=3, c=8, with_lf=True):
    gen = torch.Generator().manual_seed(seed)
    mk = lambda rows: torch.randn(b, rows, c, generator=gen, dtype=torch.float64).float()
    return (mk(hw), mk(k * hw), mk(k * hw), mk(k * hw) if with_lf else None), k


@pytest.mark.parametrize("with_lf", [True, False])
def test_chunked_attention_is_invariant_to_the_chunk(with_lf):
    """1, 4 and 16 chunks of 64 queries; outputs, masses and the gradients
    of a random projection with respect to every input."""
    (q, k, xf, lf), n_refs = attention_inputs(0, with_lf=with_lf)
    n = k.shape[1]
    proj = torch.randn(2, 64, 8, generator=torch.Generator().manual_seed(1))
    results = {}
    for chunks in (1, 4, 16):
        leaves = [t.clone().requires_grad_() for t in (q, k, xf, lf) if t is not None]
        args = leaves + ([] if with_lf else [None])
        out_x, out_l, vis = chunked_ref_attention(*args, n_refs, n * 64 // chunks)
        loss = (out_x * proj).sum() + (0 if out_l is None else (out_l * proj.flip(1)).sum())
        loss.backward()
        results[chunks] = [out_x, vis] + ([out_l] if with_lf else []) + [
            t.grad for t in leaves]
        assert (out_l is None) == (not with_lf)
        assert vis.shape == (2, 64, n_refs)
    for chunks in (4, 16):   # bmm of another shape sums in another order
        for got, want in zip(results[chunks], results[1]):
            err = (got - want).abs().max().item()
            assert err <= 1e-6 * want.abs().max().item(), (chunks, err)
    np.testing.assert_allclose(results[1][1].sum(-1).detach().numpy(), 1.0, atol=1e-6)


def test_chunked_attention_computes_in_f32_under_autocast():
    """bf16 inputs under autocast: the products and the softmax run in f32
    (JAX upcasts key, query, xf and lf), the outputs come back in the
    inputs' dtype, the masses in f32."""
    (q, k, xf, lf), n_refs = attention_inputs(2)
    bf = [t.bfloat16() for t in (q, k, xf, lf)]
    with torch.autocast("cpu", torch.bfloat16):
        out_x, out_l, vis = chunked_ref_attention(*bf, n_refs, k.shape[1] * 16)
    want = chunked_ref_attention(*[t.float() for t in bf], n_refs, k.shape[1] * 16)
    assert out_x.dtype == out_l.dtype == torch.bfloat16 and vis.dtype == torch.float32
    assert torch.equal(out_x, want[0].bfloat16()) and torch.equal(out_l, want[1].bfloat16())
    assert torch.equal(vis, want[2])


def test_a_chunk_that_does_not_divide_the_queries_leaves_a_shorter_last_one():
    """Halving from 15 queries gives chunks of 7 (where the JAX loop
    asserts): chunks of 7, 7 and 1 give the one-chunk result."""
    (q, k, xf, lf), n_refs = attention_inputs(3, hw=15)
    got = chunked_ref_attention(q, k, xf, lf, n_refs, k.shape[1] * 8)
    want = chunked_ref_attention(q, k, xf, lf, n_refs, k.shape[1] * 15)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-6 * b.abs().max().item()
