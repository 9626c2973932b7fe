"""The port's multi-reference flash attention against the JAX package, on the
CPU.

On a CPU tensor the port's `flash_ref_attention` runs its plain PyTorch
version (the CUDA kernel runs only on the card, where chip_smoke.py holds
it against the same plain version).  Here the plain version is compared
with the JAX Pallas kernel in interpret mode and with a dense softmax, at
the shapes and tolerances of tests/test_attention_kernel.py: outputs 1e-4
and per-reference masses 1e-5 in f32 (the same f32 math, summed in another
order).  The generator wiring (reshape orders, atn_sum, atn_vis) is
compared with the JAX generator's flash dispatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.models.generator import FewShotGenerator as JaxGenerator
from fsvid2vid_tpu.ops.pallas.attention_kernel import (
    flash_ref_attention as jax_flash)
from fsvid2vid_tpu_torch.config import Config as TorchConfig
from fsvid2vid_tpu_torch.models import build_generator
from fsvid2vid_tpu_torch.ops import attention_kernel as ak
from fsvid2vid_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_networks import tiny_face_cfg
from tests.test_torch_layers import randomize, to_numpy


def dense(q, k, xf, lf, n):
    energy = np.einsum("bnc,bqc->bnq", k, q)
    attn = np.exp(energy - energy.max(1, keepdims=True))
    attn /= attn.sum(1, keepdims=True)
    out_x = np.einsum("bnc,bnq->bqc", xf, attn)
    out_l = np.einsum("bnc,bnq->bqc", lf, attn) if lf is not None else None
    vis = attn.reshape(q.shape[0], n, -1, q.shape[1]).sum(2).transpose(0, 2, 1)
    return out_x, out_l, vis


def inputs(rng, b, n, hw_k, hw_q, c, has_lf):
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    return (mk(b, hw_q, c), mk(b, n * hw_k, c), mk(b, n * hw_k, c),
            mk(b, n * hw_k, c) if has_lf else None)


def plain(q, k, xf, lf, n, **kw):
    t = lambda a: None if a is None else torch.from_numpy(a)
    return ak.flash_ref_attention_plain(t(q), t(k), t(xf), t(lf), n, **kw)


@pytest.mark.parametrize("has_lf", [True, False])
def test_plain_matches_pallas_interpret_and_dense(rng, has_lf):
    """Several query chunks in the plain version (chunk_elems) and several
    q / k blocks in the Pallas kernel force the streaming rescale."""
    b, n, hw_k, hw_q, c = 2, 3, 64, 64, 16
    q, k, xf, lf = inputs(rng, b, n, hw_k, hw_q, c, has_lf)
    ox, ol, vis = plain(q, k, xf, lf, n, chunk_elems=n * hw_k * 16)
    jx, jl, jvis = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(xf),
        None if lf is None else jnp.asarray(lf), n_refs=n, q_block=16,
        k_block=32, interpret=True)
    dx, dl, dvis = dense(q, k, xf, lf, n)
    for ref_x, ref_l, ref_vis in ((np.asarray(jx), jl, np.asarray(jvis)),
                                  (dx, dl, dvis)):
        np.testing.assert_allclose(ox.numpy(), ref_x, atol=1e-4)
        np.testing.assert_allclose(vis.numpy(), ref_vis, atol=1e-5)
        if has_lf:
            np.testing.assert_allclose(ol.numpy(), np.asarray(ref_l), atol=1e-4)
        else:
            assert ol is None and ref_l is None
    np.testing.assert_allclose(vis.sum(-1).numpy(), 1.0, atol=1e-5)


def test_plain_bf16_inputs(rng):
    """bf16 in, f32 accumulation: close to the f32 dense result and to the
    Pallas kernel on the same bf16 inputs (tolerances of
    tests/test_attention_kernel.py::test_bf16_inputs)."""
    b, n, hw_k, c = 1, 2, 128, 32
    q, k, xf, _ = inputs(rng, b, n, hw_k, hw_k, c, False)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    ox, ol, vis = ak.flash_ref_attention(bf(q), bf(k), bf(xf), None, n)
    assert ox.dtype == torch.bfloat16 and ol is None
    assert vis.dtype == torch.float32
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    jx, _, jvis = jax_flash(jb(q), jb(k), jb(xf), None, n_refs=n, q_block=32,
                            k_block=64, interpret=True)
    dx, _, dvis = dense(q, k, xf, None, n)
    for ref_x, ref_vis in ((np.asarray(jx, np.float32), np.asarray(jvis)),
                           (dx, dvis)):
        err = np.abs(ox.float().numpy() - ref_x).max()
        assert err / np.abs(ref_x).max() < 0.05
        np.testing.assert_allclose(vis.numpy(), ref_vis, atol=0.03)


def test_plain_ragged_matches_dense(rng):
    """hw = 7 x 9 = 63 (not a multiple of 8), K = 3, odd channel count."""
    b, n, hw, c = 2, 3, 63, 20
    q, k, xf, lf = inputs(rng, b, n, hw, hw, c, True)
    ox, ol, vis = plain(q, k, xf, lf, n, chunk_elems=n * hw * 8)
    dx, dl, dvis = dense(q, k, xf, lf, n)
    np.testing.assert_allclose(ox.numpy(), dx, atol=1e-4)
    np.testing.assert_allclose(ol.numpy(), dl, atol=1e-4)
    np.testing.assert_allclose(vis.numpy(), dvis, atol=1e-5)


def test_cpu_wrapper_runs_plain_and_counts_no_launch(rng):
    q, k, xf, lf = inputs(rng, 1, 2, 16, 16, 8, True)
    before = ak.flash_ref_attention.launches
    t = torch.from_numpy
    got = ak.flash_ref_attention(t(q), t(k), t(xf), t(lf), 2)
    want = ak.flash_ref_attention_plain(t(q), t(k), t(xf), t(lf), 2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert ak.flash_ref_attention.launches == before


@pytest.mark.parametrize("case", ["c_too_wide", "dtype_mismatch", "n_refs",
                                  "shape", "half"])
def test_kernel_input_check_raises(case):
    """What the kernel does not take is refused before any launch."""
    f32 = torch.float32
    q, k = torch.zeros(1, 8, 16), torch.zeros(1, 24, 16)
    xf = lf = k
    n_refs = 3
    if case == "c_too_wide":
        q, k = torch.zeros(1, 8, ak.MAX_C + 1), torch.zeros(1, 24, ak.MAX_C + 1)
        xf = lf = k
    elif case == "dtype_mismatch":
        lf = k.to(torch.bfloat16)
    elif case == "n_refs":
        n_refs = 5
    elif case == "shape":
        xf = torch.zeros(1, 23, 16, dtype=f32)
    elif case == "half":
        q, k = q.half(), k.half()
        xf = lf = k
    with pytest.raises(ValueError):
        ak._check(q, k, xf, lf, n_refs)


def test_attention_module_matches_jax_flash_dispatch(rng):
    """The port's _attention_module against FewShotGenerator(
    atn_flash='interpret')._attention_module (the Pallas kernel on the JAX
    side): all four outputs."""
    cfg = tiny_face_cfg(n_shot=3, is_train=False)
    h, w, cl = cfg.height, cfg.width, cfg.gen_input_nc
    b, k = 2, 3
    label = rng.randn(b, h, w, cl).astype(np.float32)
    label_refs = rng.randn(b, k, h, w, cl).astype(np.float32)
    img_refs = rng.randn(b, k, h, w, 3).astype(np.float32)
    jm = JaxGenerator(cfg, atn_flash="interpret")
    # warp_prev so that the temporal branch's variables exist too
    shapes = jax.eval_shape(
        lambda *a: jm.init(*a, warp_prev=True, train=False),
        jax.random.PRNGKey(0), jnp.asarray(label), jnp.asarray(label_refs),
        jnp.asarray(img_refs), jnp.asarray(label), jnp.asarray(img_refs[:, 0]))
    vs = randomize(shapes, rng)

    ha, wa = h // 2 ** cfg.n_downsample_A, w // 2 ** cfg.n_downsample_A
    ca = cfg.ngf * 2 ** cfg.n_downsample_A
    x = rng.randn(b * k, ha, wa, ca).astype(np.float32)
    xl = rng.randn(b * k, ha, wa, ca).astype(np.float32)
    lbl_flat = label_refs.reshape(b * k, h, w, cl)
    ox, ol, s, v = jm.apply(
        vs, jnp.asarray(x), jnp.asarray(xl), jnp.asarray(label),
        jnp.asarray(lbl_flat), False,
        method=lambda m, *a: m._attention_module(*a), mutable=False)

    tcfg = TorchConfig.from_json(cfg.to_json())
    g = build_generator(tcfg, device="cpu")
    g.load_state_dict(state_dict_from_jax(to_numpy(vs), tcfg), strict=True)
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        tx, tl_, ts, tv = g._attention_module(nchw(x), nchw(xl), nchw(label),
                                              nchw(lbl_flat))
    np.testing.assert_allclose(tx.permute(0, 2, 3, 1).numpy(), np.asarray(ox),
                               atol=1e-4)
    np.testing.assert_allclose(tl_.permute(0, 2, 3, 1).numpy(), np.asarray(ol),
                               atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v), atol=1e-5)
