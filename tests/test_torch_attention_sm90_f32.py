"""The port's f32 tensor-core route of kernel B1 (the f32 instance of
csrc/flash_ref_attention_sm90.cu), as far as the CPU can check it.

The kernel itself runs only on the card (chip_smoke.py holds it against the
plain version there).  Here:
  * the route rule and the sm90_f32 route's input checks, which raise before
    any launch;
  * a pure-torch emulation of the kernel's arithmetic: q and k split into 3
    bf16 parts and QK^T as the 6 cross products hh, hm, mh, hl, lh, mm
    summed in f32; xf, lf and p split into 2 parts and PV as p_lo V_hi +
    p_hi V_lo + p_hi V_hi; key tiles of 32 keys aligned to reference starts
    with masked tails and zero-filled past N; the per-reference mass from
    (s_r, m_r); the accumulators flushed every few tiles into a separate f32
    sum rescaled by the running max.  It is held against the JAX package
    (the Pallas kernel in interpret mode where it takes the shape, else the
    JAX generator's XLA softmax) and a dense numpy softmax with the f32
    tolerances of the suite (outputs 1e-4, masses 1e-5), at energies with a
    standard deviation of ~4 and of ~16.  At ~16 a split of q and k into
    only 2 parts no longer holds the masses, which is why the kernel takes 3.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.ops.pallas.attention_kernel import (
    flash_ref_attention as jax_flash)
from fsvid2vid_tpu_torch.ops import attention_kernel as ak
from tests.test_torch_attention import dense, inputs
from tests.test_torch_attention_sm90 import LOG2E, jax_xla

BK = 32                                         # keys per tile in the kernel
QK_PRODUCTS = [(1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0)]   # (q part, k part)


def split_bf16(x, parts):
    """x = sum of `parts` bf16 values (as f32): each the bf16 rounding of what
    the earlier parts leave."""
    out = []
    for _ in range(parts):
        hi = x.to(torch.bfloat16).float()
        out.append(hi)
        x = x - hi
    return out


def test_split_parts_carry_f32():
    x = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32)) * 7
    three = split_bf16(x, 3)
    assert all(torch.equal(p, p.to(torch.bfloat16).float()) for p in three)
    assert torch.equal(three[0] + three[1] + three[2], x)     # 24 bits: exact
    two = sum(split_bf16(x, 2))
    assert ((two - x).abs() <= x.abs() * 2.0 ** -16).all()


@pytest.mark.parametrize("dtype,c,route", [
    (torch.float32, 128, "sm90_f32"),
    (torch.float32, 40, "sm90_f32"),
    (torch.float32, 8, "sm90_f32"),
    (torch.float32, 36, "sm90_ragged_f32"),
    (torch.float32, 136, "sm90_wide_f32"),
    (torch.bfloat16, 36, "sm90_ragged"),
    (torch.bfloat16, 128, "sm90"),
])
def test_f32_route_rule(dtype, c, route):
    assert ak.route_for("cuda", dtype, c) == route
    assert ak.route_for("cpu", dtype, c) == "plain"


def _f32_inputs(hw=8, n_refs=3, c=16, has_lf=True):
    q = torch.zeros(1, hw, c)
    k = torch.zeros(1, n_refs * hw, c)
    return q, k, k.clone(), k.clone() if has_lf else None, n_refs


@pytest.mark.parametrize("case", ["bf16", "c_not_multiple_of_8", "c_too_wide",
                                  "misaligned", "too_many_refs", "shape"])
def test_sm90_f32_input_check_raises(case):
    """What the sm90_f32 kernel does not take is refused before any launch."""
    q, k, xf, lf, n_refs = _f32_inputs()
    if case == "bf16":
        q, k, xf, lf = (t.bfloat16() for t in (q, k, xf, lf))
    elif case == "c_not_multiple_of_8":   # the ragged route's
        q, k, xf, lf, n_refs = _f32_inputs(c=36)
    elif case == "c_too_wide":
        q, k, xf, lf, n_refs = _f32_inputs(c=ak.NARROW_MAX_C + 8)   # the wide route's
    elif case == "misaligned":     # a contiguous view 4 bytes into its storage
        xf = torch.zeros(k.numel() + 1)[1:].view(k.shape)
    elif case == "too_many_refs":  # the (128, n_refs) mass table overflows
        q, k, xf, lf, n_refs = _f32_inputs(hw=1, n_refs=18, c=128)
    elif case == "shape":
        lf = lf[:, :-1].contiguous()
    with pytest.raises(ValueError):
        ak._check_tensor_core("sm90_f32", q, k, xf, lf, n_refs)


def test_sm90_f32_check_takes_the_serving_shape():
    """Face 512 px at K = 8 (c = 128 with lf) fits, and so do 17 references;
    the shared memory is the 96 KB query tile, two 56 KB stages and the table."""
    q, k, xf, lf, n_refs = _f32_inputs(hw=16, n_refs=8, c=128)
    ak._check_tensor_core("sm90_f32", q, k, xf, lf, n_refs)
    assert ak.sm90_f32_smem_bytes(128, 8, True) == 1024 + 98304 + 2 * 57344 + 40 + 8192
    assert ak.sm90_f32_smem_bytes(128, 17, True) <= ak.SMEM_LIMIT
    assert ak.sm90_f32_smem_bytes(128, 18, True) > ak.SMEM_LIMIT


def emulate_sm90_f32(q, k, xf, lf, n_refs, flush_tiles, bk=BK, products=QK_PRODUCTS):
    """The kernel's arithmetic in f32 torch: every query row at once (rows
    are independent), key tiles reference by reference; QK^T as the given
    (q part, k part) products."""
    b, hw, _ = q.shape
    n = k.shape[1]
    hw_key = n // n_refs
    tiles_per_ref = math.ceil(hw_key / bk)
    values = torch.cat([xf] + ([lf] if lf is not None else []), -1)
    pad = lambda t: torch.cat([t, t.new_zeros(b, bk, t.shape[2])], 1)   # TMA zero-fill
    q_parts, k_parts = split_bf16(q, 3), split_bf16(pad(k), 3)
    v_hi, v_lo = split_bf16(pad(values), 2)
    m = torch.full((b, hw), -math.inf)
    l = torch.zeros(b, hw)
    o = torch.zeros(b, hw, values.shape[2])
    flushed, m_flushed = torch.zeros_like(o), torch.full((b, hw), -math.inf)
    s_ref, m_ref = torch.zeros(b, hw, n_refs), torch.zeros(b, hw, n_refs)
    t = 0
    for r in range(n_refs):
        sr = torch.zeros(b, hw)
        for j in range(tiles_per_ref):
            if flush_tiles and t and t % flush_tiles == 0:
                flushed = flushed * torch.exp2(m_flushed - m)[..., None] + o
                o, m_flushed = torch.zeros_like(o), m
            row = r * hw_key + j * bk
            s = sum(q_parts[a] @ k_parts[c][:, row:row + bk].transpose(1, 2)
                    for a, c in products)                            # (b, hw, bk)
            valid = hw_key - j * bk
            if valid < bk:
                s[..., valid:] = -math.inf
            m_new = torch.maximum(m, s.amax(-1) * LOG2E)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * LOG2E - m_new[..., None])
            l = alpha * l + p.sum(-1)
            sr = alpha * sr + p.sum(-1)
            p_hi, p_lo = split_bf16(p, 2)
            tile = slice(row, row + bk)
            o = alpha[..., None] * o + (p_lo @ v_hi[:, tile] + p_hi @ v_lo[:, tile]
                                        + p_hi @ v_hi[:, tile])
            m = m_new
            t += 1
        s_ref[..., r], m_ref[..., r] = sr, m
    if flush_tiles and t > flush_tiles:
        o = o + flushed * torch.exp2(m_flushed - m)[..., None]
    out = o / l[..., None]
    c = xf.shape[2]
    vis = s_ref * torch.exp2(m_ref - m[..., None]) / l[..., None]
    return out[..., :c], (out[..., c:] if lf is not None else None), vis


@pytest.mark.parametrize("n_refs,hw_key,hw_q,has_lf,flush_tiles", [
    (3, 143, 50, True, 2),     # hw_key not a multiple of 32: masked tails
    (3, 143, 50, False, 0),
    (5, 24, 48, True, 3),      # hw_key < 32: every tile is a masked tail
    (4, 64, 40, True, 0),      # whole tiles; the Pallas kernel takes the shape
    (4, 64, 40, False, 5),
])
def test_emulated_split_matches_jax_and_dense(rng, n_refs, hw_key, hw_q, has_lf,
                                              flush_tiles):
    b, c = 2, 16
    q, k, xf, lf = inputs(rng, b, n_refs, hw_key, hw_q, c, has_lf)
    t = lambda a: None if a is None else torch.from_numpy(a)
    ex, el, evis = emulate_sm90_f32(t(q), t(k), t(xf), t(lf), n_refs, flush_tiles)
    j = lambda a: None if a is None else jnp.asarray(a)
    if hw_key % 8 == 0:
        jx, jl, jvis = jax_flash(j(q), j(k), j(xf), j(lf), n_refs=n_refs,
                                 q_block=8, k_block=8, interpret=True)
    else:
        jx, jl, attn = jax_xla(j(q), j(k), j(xf), j(lf))
        jvis = attn.reshape(b, n_refs, hw_key, hw_q).sum(2).transpose(0, 2, 1)
    dx, dl, dvis = dense(q, k, xf, lf, n_refs)
    for ref_x, ref_l, ref_vis in ((np.asarray(jx), jl, np.asarray(jvis)),
                                  (dx, dl, dvis)):
        np.testing.assert_allclose(ex.numpy(), ref_x, atol=1e-4)
        np.testing.assert_allclose(evis.numpy(), ref_vis, atol=1e-5)
        if has_lf:
            np.testing.assert_allclose(el.numpy(), np.asarray(ref_l), atol=1e-4)
        else:
            assert el is None and ref_l is None


@pytest.mark.parametrize("flush_tiles", [0, 2])
def test_emulated_split_sharp_energies(rng, flush_tiles):
    """Energies 4x sharper (std ~16 at c = 16): an energy's error is the
    weight's relative error, so the 3-part split of q and k is what holds the
    masses to 1e-5 here."""
    n_refs, hw_key, hw_q, c = 3, 143, 40, 16
    q, k, xf, lf = inputs(rng, 1, n_refs, hw_key, hw_q, c, True)
    q *= 4.0
    t = torch.from_numpy
    ex, el, evis = emulate_sm90_f32(t(q), t(k), t(xf), t(lf), n_refs, flush_tiles)
    dx, dl, dvis = dense(q, k, xf, lf, n_refs)
    np.testing.assert_allclose(ex.numpy(), dx, atol=1e-4)
    np.testing.assert_allclose(el.numpy(), dl, atol=1e-4)
    np.testing.assert_allclose(evis.numpy(), dvis, atol=1e-5)


def test_flush_is_exact_rescaling(rng):
    """Flushing changes only where the sum is kept: with and without it the
    emulated outputs agree to f32 rounding."""
    q, k, xf, lf = inputs(rng, 1, 4, 64, 24, 16, True)
    t = torch.from_numpy
    a = emulate_sm90_f32(t(q), t(k), t(xf), t(lf), 4, 0)
    b = emulate_sm90_f32(t(q), t(k), t(xf), t(lf), 4, 1)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=2e-6)


def test_two_part_split_breaks_the_sharp_masses(rng):
    """The same sharp energies with q and k in 2 bf16 parts (QK^T as hh, hm,
    mh: what the 3-part split's first products are): the masses miss 1e-5,
    where the 3 parts of test_emulated_split_sharp_energies hold it."""
    n_refs, hw_key, hw_q, c = 3, 143, 40, 16
    q, k, xf, lf = inputs(rng, 1, n_refs, hw_key, hw_q, c, True)
    q *= 4.0
    t = torch.from_numpy
    _, _, dvis = dense(q, k, xf, lf, n_refs)
    errs = {name: np.abs(emulate_sm90_f32(t(q), t(k), t(xf), t(lf), n_refs, 0,
                                          products=products)[2].numpy() - dvis).max()
            for name, products in (("three", QK_PRODUCTS), ("two", QK_PRODUCTS[3:]))}
    assert QK_PRODUCTS[3:] == [(1, 0), (0, 1), (0, 0)]
    assert errs["three"] <= 1e-5 < errs["two"], errs
