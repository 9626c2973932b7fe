"""Kernel B1 at every channel count the JAX generator sends to its Pallas
kernel (1 <= c <= 512): the routes of ops/attention_kernel.py for
c % 8 != 0 and for 128 < c <= 512, as far as the CPU can check them.

The kernels run only on the card (chip_smoke.py holds them against the plain
version there).  Here:
  * the route rule for every c of both dtypes, the input checks, and the
    shared memory of every route (Python mirrors of the kernel's
    smem_bytes) under the limit for every c in 1..512 at K = 8;
  * the generator's eval dispatch: B1 for c <= 512, `chunked_ref_attention`
    beyond, as the JAX generator's `use_flash` (generator.py:288-292);
  * pure-torch emulations of the two new walks, held against the JAX Pallas
    kernel in interpret mode and a dense numpy softmax with the suite's f32
    tolerances (outputs 1e-4, masses 1e-5: the same f32 math in another
    order), in bf16's arithmetic (one part) and in f32's (split-bf16
    products, flushes):
      - c % 8 != 0: the pre-pass's zero-padding to a multiple of 8 channels,
        then the narrow walk of tests/test_torch_attention_sm90*.py;
      - 128 < c <= 512: the wide walk, QK^T summed over 64-channel chunks
        of the query and key boxes (TMA zero-fills the last box past cp),
        the value channels [xf | lf] cut into slices of 4 boxes, each slice
        its own walk with its own S, and every slice's masses identical;
  * the port's `_attention_module` and the whole eval forward of a small
    K = 2 generator at ngf 9 (c = 36) and ngf 40 (c = 160) against the JAX
    generator with atn_flash='interpret': 1e-4 on attention outputs and
    images, as tests/test_torch_attention.py and test_torch_generator.py.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fsvid2vid_tpu.ops.pallas.attention_kernel import (
    flash_ref_attention as jax_flash)
from fsvid2vid_tpu_torch.ops import attention_kernel as ak
from tests.test_torch_attention import dense, inputs
from tests.test_torch_attention_sm90 import LOG2E, emulate_sm90
from tests.test_torch_attention_sm90_f32 import QK_PRODUCTS, emulate_sm90_f32, split_bf16

ROUTES = {  # c -> (bf16 route, f32 route)
    20: ("sm90_ragged", "sm90_ragged_f32"), 36: ("sm90_ragged", "sm90_ragged_f32"),
    124: ("sm90_ragged", "sm90_ragged_f32"), 128: ("sm90", "sm90_f32"),
    136: ("sm90_wide", "sm90_wide_f32"), 256: ("sm90_wide", "sm90_wide_f32"),
    512: ("sm90_wide", "sm90_wide_f32")}


@pytest.mark.parametrize("c", sorted(ROUTES))
def test_route_rule(c):
    assert (ak.route_for("cuda", torch.bfloat16, c),
            ak.route_for("cuda", torch.float32, c)) == ROUTES[c]
    assert ak.route_for("cpu", torch.float32, c) == "plain"


def test_every_channel_count_takes_a_tensor_core_route():
    """Every c in 1..512 of either dtype takes a tensor-core route."""
    for dtype in (torch.bfloat16, torch.float32):
        routes = {ak.route_for("cuda", dtype, c) for c in range(1, ak.MAX_C + 1)}
        assert routes <= set(ak._TC_ROUTES), routes


def _zeros(dtype, c, hw=8, n_refs=3, has_lf=True):
    q = torch.zeros(1, hw, c, dtype=dtype)
    k = torch.zeros(1, n_refs * hw, c, dtype=dtype)
    return q, k, k.clone(), k.clone() if has_lf else None, n_refs


def test_check_refuses_c_past_512():
    ak._check(*_zeros(torch.float32, 512))
    with pytest.raises(ValueError, match="outside 1..512"):
        ak._check(*_zeros(torch.float32, 513))


@pytest.mark.parametrize("route,dtype,c,takes", [
    ("sm90_ragged", torch.bfloat16, 36, True),
    ("sm90_ragged", torch.bfloat16, 40, False),      # c % 8 == 0: the sm90 route's
    ("sm90_ragged_f32", torch.float32, 9, True),
    ("sm90_ragged_f32", torch.bfloat16, 9, False),   # dtype
    ("sm90_wide", torch.bfloat16, 136, True),
    ("sm90_wide", torch.bfloat16, 164, True),        # wide and ragged: padded too
    ("sm90_wide", torch.bfloat16, 128, False),       # the narrow walk's
    ("sm90_wide_f32", torch.float32, 512, True),
    ("sm90_wide_f32", torch.float32, 520, False),    # past MAX_C
    ("sm90", torch.bfloat16, 136, False),            # past the narrow walk
])
def test_route_checks(route, dtype, c, takes):
    args = _zeros(dtype, c)
    if takes:
        ak._check_tensor_core(route, *args)
    else:
        with pytest.raises(ValueError):
            ak._check_tensor_core(route, *args)


@pytest.mark.parametrize("has_lf", [True, False])
def test_shared_memory_fits_every_channel_count_at_k8(has_lf):
    """The smem mirrors of every route that takes c, for c in 1..512, 8
    references; the wide walk's rings do not grow with c."""
    for c in range(1, ak.MAX_C + 1):
        for dtype in (torch.bfloat16, torch.float32):
            route = ak.route_for("cuda", dtype, c)
            assert ak._TC_ROUTES[route][1](c)
            assert ak._TC_ROUTES[route][2](c, 8, has_lf) <= ak.SMEM_LIMIT, (route, c)
    assert ak.sm90_wide_smem_bytes(256, 8, True) == 1024 + 4 * 24576 + 2 * 32768 + 96 + 8192
    assert ak.sm90_wide_f32_smem_bytes(256, 8, True) == (1024 + 3 * 61440 + 32768 + 64
                                                         + 8192)
    assert ak.sm90_wide_f32_smem_bytes(512, 13, True) <= ak.SMEM_LIMIT
    assert ak.sm90_wide_f32_smem_bytes(512, 14, True) > ak.SMEM_LIMIT


@pytest.mark.parametrize("c,has_lf,slices", [(136, True, 2), (136, False, 1), (256, True, 2),
                                             (256, False, 1), (320, True, 3), (512, True, 4)])
def test_wide_slices(c, has_lf, slices):
    assert ak.wide_slices(c, has_lf) == slices


# ----------------------------------------------------------------------
# the eval dispatch
# ----------------------------------------------------------------------
def test_eval_dispatch_sends_c_past_512_to_the_chunked_attention(rng):
    """c = 520 (ngf 130 with n_downsample_A 2): the chunked attention, as the
    JAX generator's non-flash branch; c = 512: B1.  The encoders are
    replaced by 520- or 512-channel features, so no wide model is built."""
    from fsvid2vid_tpu_torch.config import face_config
    from fsvid2vid_tpu_torch.models import build_generator
    cfg = face_config(ngf=4, nff=4, fine_size=32, load_size=32, n_blocks_F=1, n_shot=2,
                      n_downsample_G=3, n_adaptive_layers=2, batch_size=1, is_train=False)
    g = build_generator(cfg, device="cpu").eval()
    b, k, h, w = 1, 2, 4, 4
    for c, kernel in ((520, False), (512, True)):
        feats = {kind: torch.from_numpy(rng.randn(n, c, h, w).astype(np.float32))
                 for kind, n in (("key", b * k), ("query", b))}
        g._attention_encode = lambda x, kind, feats=feats: feats[kind]
        calls = []
        g.attention = lambda *a: calls.append(a) or ak.flash_ref_attention_plain(*a)
        x = torch.from_numpy(rng.randn(b * k, c, h, w).astype(np.float32))
        xl = torch.from_numpy(rng.randn(b * k, c, h, w).astype(np.float32))
        label = torch.zeros(b, cfg.gen_input_nc, 16, 16)
        with torch.no_grad():
            ox, ol, s, v = g._attention_module(x, xl, label, label.repeat(k, 1, 1, 1))
        assert bool(calls) == kernel, c
        tok = lambda t: t.permute(0, 2, 3, 1).reshape(1, -1, c).numpy()
        dx, dl, dvis = dense(tok(feats["query"]), tok(feats["key"]), tok(x), tok(xl), k)
        np.testing.assert_allclose(ox.permute(0, 2, 3, 1).reshape(1, -1, c).numpy(), dx,
                                   atol=1e-4)
        np.testing.assert_allclose(ol.permute(0, 2, 3, 1).reshape(1, -1, c).numpy(), dl,
                                   atol=1e-4)
        np.testing.assert_allclose(s.numpy(), dvis.sum(1), rtol=1e-4)


# ----------------------------------------------------------------------
# emulated walks
# ----------------------------------------------------------------------
def pad_channels(t, width):
    return None if t is None else F.pad(t, (0, width - t.shape[2]))


def emulate_ragged(q, k, xf, lf, n_refs, f32, flush_tiles=0):
    """The ragged routes: the pre-pass writes the inputs zero-padded to
    cp = padded_c(c) channels, the narrow walk runs at cp, and the stores
    stop at c."""
    c, cp = q.shape[2], ak.padded_c(q.shape[2])
    padded = [pad_channels(t, cp) for t in (q, k, xf, lf)]
    if f32:
        ox, ol, vis = emulate_sm90_f32(*padded, n_refs, flush_tiles)
    else:
        ox, ol, vis = emulate_sm90(*padded, n_refs)
    return ox[..., :c], (None if ol is None else ol[..., :c]), vis


def emulate_wide(q, k, xf, lf, n_refs, f32, flush_tiles=0):
    """The wide walk in f32 torch: every query row at once (rows are
    independent), key tiles of bk keys reference by reference (32 in f32,
    64 in bf16), QK^T chunk by chunk of 64 channels (f32: each chunk's 6
    split products), one walk per slice of 4 value boxes of [xf | lf]."""
    b, hw, c = q.shape
    n = k.shape[1]
    hw_key = n // n_refs
    bk = 32 if f32 else 64
    tiles_per_ref = math.ceil(hw_key / bk)
    nq = -(-ak.padded_c(c) // 64)
    # the pre-pass pads to cp, TMA's zero-fill to the last box's end: 64 nq
    width = 64 * nq
    qz, kz, xz, lz = (pad_channels(t, width) for t in (q, k, xf, lf))
    kz = torch.cat([kz, kz.new_zeros(b, bk, width)], 1)   # TMA zero-fill past N
    values = [t[..., 64 * j:64 * j + 64] for t in (xz, lz) if t is not None for j in range(nq)]
    values = [torch.cat([v, v.new_zeros(b, bk, 64)], 1) for v in values]
    products = QK_PRODUCTS if f32 else [(0, 0)]
    q_parts = split_bf16(qz, 3) if f32 else [qz]
    k_parts = split_bf16(kz, 3) if f32 else [kz]
    outs, masses = [], []
    for v0 in range(0, len(values), ak.WIDE_VALUE_BOXES):
        v_slice = torch.cat(values[v0:v0 + ak.WIDE_VALUE_BOXES], -1)
        v_parts = split_bf16(v_slice, 2) if f32 else [v_slice]
        m = torch.full((b, hw), -math.inf)
        l = torch.zeros(b, hw)
        o = torch.zeros(b, hw, v_slice.shape[2])
        flushed, m_flushed = torch.zeros_like(o), torch.full((b, hw), -math.inf)
        s_ref, m_ref = torch.zeros(b, hw, n_refs), torch.zeros(b, hw, n_refs)
        t = 0
        for r in range(n_refs):
            sr = torch.zeros(b, hw)
            for j in range(tiles_per_ref):
                if flush_tiles and t and t % flush_tiles == 0:
                    flushed = flushed * torch.exp2(m_flushed - m)[..., None] + o
                    o, m_flushed = torch.zeros_like(o), m
                rows = slice(r * hw_key + j * bk, r * hw_key + (j + 1) * bk)
                s = torch.zeros(b, hw, bk)
                for cb in range(nq):
                    ch = slice(64 * cb, 64 * cb + 64)
                    for a, e in products:
                        s = s + q_parts[a][..., ch] @ k_parts[e][:, rows, ch].transpose(1, 2)
                valid = hw_key - j * bk
                if valid < bk:
                    s[..., valid:] = -math.inf
                m_new = torch.maximum(m, s.amax(-1) * LOG2E)
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s * LOG2E - m_new[..., None])
                l = alpha * l + p.sum(-1)
                sr = alpha * sr + p.sum(-1)
                if f32:
                    p_hi, p_lo = split_bf16(p, 2)
                    pv = (p_lo @ v_parts[0][:, rows] + p_hi @ v_parts[1][:, rows]
                          + p_hi @ v_parts[0][:, rows])
                else:
                    pv = p @ v_parts[0][:, rows]
                o = alpha[..., None] * o + pv
                m = m_new
                t += 1
            s_ref[..., r], m_ref[..., r] = sr, m
        if flush_tiles and t > flush_tiles:
            o = o + flushed * torch.exp2(m_flushed - m)[..., None]
        outs.append(o / l[..., None])
        masses.append(s_ref * torch.exp2(m_ref - m[..., None]) / l[..., None])
    assert all(torch.equal(v, masses[0]) for v in masses)   # every slice's S is the same
    out = torch.cat(outs, -1)
    out_x = out[..., :width][..., :c]
    out_l = None if lf is None else out[..., width:2 * width][..., :c]
    return out_x, out_l, masses[0]


def _check_against_jax_and_dense(rng, emulate, c, n_refs, hw_key, hw_q, has_lf, **kw):
    b = 1
    q, k, xf, lf = inputs(rng, b, n_refs, hw_key, hw_q, c, has_lf)
    q *= 4.0 / c ** 0.25   # energies of std ~4 at any c, as chip_smoke.py draws them
    k *= 1.0 / c ** 0.25
    t = lambda a: None if a is None else torch.from_numpy(a)
    ex, el, evis = emulate(t(q), t(k), t(xf), t(lf), n_refs, **kw)
    j = lambda a: None if a is None else jnp.asarray(a)
    jx, jl, jvis = jax_flash(j(q), j(k), j(xf), j(lf), n_refs=n_refs, q_block=8, k_block=32,
                             interpret=True)
    dx, dl, dvis = dense(q, k, xf, lf, n_refs)
    for ref_x, ref_l, ref_vis in ((np.asarray(jx), jl, np.asarray(jvis)), (dx, dl, dvis)):
        np.testing.assert_allclose(ex.numpy(), ref_x, atol=1e-4)
        np.testing.assert_allclose(evis.numpy(), ref_vis, atol=1e-5)
        if has_lf:
            np.testing.assert_allclose(el.numpy(), np.asarray(ref_l), atol=1e-4)
        else:
            assert el is None and ref_l is None


@pytest.mark.parametrize("f32,has_lf,flush_tiles", [(False, True, 0), (False, False, 0),
                                                    (True, True, 3), (True, False, 0)])
def test_emulated_ragged_walk_c36_matches_jax_and_dense(rng, f32, has_lf, flush_tiles):
    """c = 36 (ngf 9): padded to 40; hw_key = 96, not a multiple of 64."""
    kw = {"flush_tiles": flush_tiles} if f32 else {}
    _check_against_jax_and_dense(rng, emulate_ragged, 36, 3, 96, 40, has_lf, f32=f32, **kw)


@pytest.mark.parametrize("c,f32,has_lf,flush_tiles", [
    (256, False, True, 0),     # 4 chunks, 2 slices: [xf] and [lf]
    (256, True, True, 2),
    (256, True, False, 0),     # 1 slice
    (164, False, True, 0),     # padded to 168: 3 chunks, the last partly zero; 2 slices,
    (164, True, True, 0),      # the second of 2 boxes
])
def test_emulated_wide_walk_matches_jax_and_dense(rng, c, f32, has_lf, flush_tiles):
    kw = {"flush_tiles": flush_tiles} if f32 else {}
    _check_against_jax_and_dense(rng, emulate_wide, c, 3, 96, 40, has_lf, f32=f32, **kw)


def test_emulated_walks_agree_with_the_narrow_one_at_c128(rng):
    """At c = 128 the wide walk (2 chunks, 1 slice without lf) computes what
    the narrow walk does, within the suite's tolerances: the chunks only
    reorder QK^T's sum."""
    q, k, xf, _ = inputs(rng, 1, 2, 64, 24, 128, False)
    q *= 4.0 / 128 ** 0.25
    k *= 1.0 / 128 ** 0.25
    t = torch.from_numpy
    for f32, narrow in ((False, emulate_sm90), (True, emulate_sm90_f32)):
        args = (t(q), t(k), t(xf), None, 2)
        a = narrow(*args, 0) if f32 else narrow(*args)
        w = emulate_wide(*args, f32=f32)
        np.testing.assert_allclose(a[0].numpy(), w[0].numpy(), atol=1e-4)
        np.testing.assert_allclose(a[2].numpy(), w[2].numpy(), atol=1e-5)


# ----------------------------------------------------------------------
# the generator at ngf 9 and 40
# ----------------------------------------------------------------------
_PAIRS = {}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _pair(ngf):
    """A K = 2 JAX generator (atn_flash='interpret') and the port's, with the
    same numpy-drawn variables, at 32 px with n_downsample_G 3 (so ngf 40
    stays small: up to 320 channels); c = 4 ngf at the attention, over
    8 x 8 positions."""
    from tests.test_torch_generator import Pair
    if ngf not in _PAIRS:
        _PAIRS[ngf] = Pair(2, seed=ngf, ngf=ngf, nff=4, n_downsample_G=3,
                           n_adaptive_layers=2, fine_size=32, load_size=32)
    return _PAIRS[ngf]


@pytest.mark.parametrize("ngf", [9, 40])
def test_attention_module_matches_jax_flash_dispatch(rng, ngf):
    """The module alone on random features, as
    tests/test_torch_attention.py's, at c = 36 and c = 160."""
    pair = _pair(ngf)
    cfg = pair.cfg
    b, k = 1, 2
    h, w, cl = cfg.height, cfg.width, cfg.gen_input_nc
    ha, wa = h // 2 ** cfg.n_downsample_A, w // 2 ** cfg.n_downsample_A
    ca = cfg.ngf * 2 ** cfg.n_downsample_A
    assert ca == 4 * ngf
    label = rng.randn(b, h, w, cl).astype(np.float32)
    lbl_flat = rng.randn(b * k, h, w, cl).astype(np.float32)
    x = rng.randn(b * k, ha, wa, ca).astype(np.float32)
    xl = rng.randn(b * k, ha, wa, ca).astype(np.float32)
    ox, ol, s, v = pair.jm.apply(
        pair.folded, jnp.asarray(x), jnp.asarray(xl), jnp.asarray(label),
        jnp.asarray(lbl_flat), False, method=lambda m, *a: m._attention_module(*a),
        mutable=False)
    with torch.no_grad():
        tx, tl_, ts, tv = pair.g._attention_module(*map(nchw, (x, xl, label, lbl_flat)))
    np.testing.assert_allclose(tx.permute(0, 2, 3, 1).numpy(), np.asarray(ox), atol=1e-4)
    np.testing.assert_allclose(tl_.permute(0, 2, 3, 1).numpy(), np.asarray(ol), atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v), atol=1e-5)


@pytest.mark.parametrize("ngf", [9, 40])
def test_eval_forward_matches_jax(ngf):
    """The whole K = 2 eval forward with the encode_reference_multi prefix
    and a previous frame: images, flows, masks, warps, atn_vis, ref_idx."""
    from tests.test_torch_generator import run_forward_with_prefix
    run_forward_with_prefix(_pair(ngf))
