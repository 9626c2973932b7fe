"""The port's bf16 tensor-core route of kernel B1 (csrc/flash_ref_attention_sm90.cu),
as far as the CPU can check it.

The kernel itself runs only on the card (chip_smoke.py holds it against the
plain version there).  Here:
  * the route rule of ops/attention_kernel.py, from dtype and shape alone;
  * the sm90 route's input checks, which raise before any launch;
  * a pure-torch emulation of the kernel's walk over the keys: tiles of BK
    keys aligned to reference starts, the columns of a reference's last tile
    past hw_key masked, key tiles zero-filled past N as TMA does, and the
    per-reference mass taken as (s_r, m_r) at each reference's end and
    finished as vis[r] = s_r * 2^(m_r - m_final) / l_final.  It is held
    against the JAX package and a dense numpy softmax in f32, with the suite's
    tolerances (outputs 1e-4, masses 1e-5: the same f32 math in another
    order).  The Pallas kernel takes only hw_key % 8 == 0 (the JAX generator
    sends other shapes to its XLA softmax, fsvid2vid_tpu/models/generator.py:288-333),
    so at hw_key = 143 the JAX side is that XLA formulation.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.ops.pallas.attention_kernel import (
    flash_ref_attention as jax_flash)
from fsvid2vid_tpu_torch.ops import attention_kernel as ak
from tests.test_torch_attention import dense, inputs

BK = 64                      # keys per tile in the kernel
LOG2E = 1.4426950408889634


@pytest.mark.parametrize("device_type,dtype,c,route", [
    ("cpu", torch.bfloat16, 128, "plain"),
    ("cpu", torch.float32, 128, "plain"),
    ("cuda", torch.bfloat16, 128, "sm90"),
    ("cuda", torch.bfloat16, 40, "sm90"),
    ("cuda", torch.float32, 128, "sm90_f32"),
    ("cuda", torch.float32, 40, "sm90_f32"),
    ("cuda", torch.float32, 36, "sm90_ragged_f32"),
    ("cuda", torch.bfloat16, 20, "sm90_ragged"),
])
def test_route_rule(device_type, dtype, c, route):
    assert ak.route_for(device_type, dtype, c) == route


def _bf16_inputs(hw=8, n_refs=3, c=16, has_lf=True):
    q = torch.zeros(1, hw, c, dtype=torch.bfloat16)
    k = torch.zeros(1, n_refs * hw, c, dtype=torch.bfloat16)
    return q, k, k.clone(), k.clone() if has_lf else None, n_refs


@pytest.mark.parametrize("case", ["f32", "c_not_multiple_of_8", "c_too_wide",
                                  "misaligned", "too_many_refs", "shape"])
def test_sm90_input_check_raises(case):
    """What the sm90 kernel does not take is refused before any launch."""
    q, k, xf, lf, n_refs = _bf16_inputs()
    if case == "f32":
        q, k, xf, lf = (t.float() for t in (q, k, xf, lf))
    elif case == "c_not_multiple_of_8":   # the ragged route's
        q, k, xf, lf, n_refs = _bf16_inputs(c=20)
    elif case == "c_too_wide":
        q, k, xf, lf, n_refs = _bf16_inputs(c=ak.NARROW_MAX_C + 8)   # the wide route's
    elif case == "misaligned":     # a contiguous view 2 bytes into its storage
        xf = torch.zeros(k.numel() + 1, dtype=torch.bfloat16)[1:].view(k.shape)
    elif case == "too_many_refs":  # the (128, n_refs) mass table overflows
        q, k, xf, lf, n_refs = _bf16_inputs(hw=1, n_refs=200)
    elif case == "shape":
        lf = lf[:, :-1].contiguous()
    with pytest.raises(ValueError):
        ak._check_tensor_core("sm90", q, k, xf, lf, n_refs)


def test_sm90_check_takes_the_serving_shape():
    q, k, xf, lf, n_refs = _bf16_inputs(hw=16, n_refs=8, c=128)
    ak._check_tensor_core("sm90", q, k, xf, lf, n_refs)
    assert ak.sm90_smem_bytes(128, 8, True) <= ak.SMEM_LIMIT


def emulate_sm90(q, k, xf, lf, n_refs, bk=BK):
    """The kernel's walk in f32 torch: every query row at once (rows are
    independent), key tiles reference by reference."""
    b, hw, _ = q.shape
    n = k.shape[1]
    hw_key = n // n_refs
    tiles_per_ref = math.ceil(hw_key / bk)
    values = torch.cat([xf] + ([lf] if lf is not None else []), -1)
    pad = lambda t: torch.cat([t, t.new_zeros(b, bk, t.shape[2])], 1)   # TMA zero-fill
    kp, vp = pad(k), pad(values)
    m = torch.full((b, hw), -math.inf)
    l = torch.zeros(b, hw)
    o = torch.zeros(b, hw, values.shape[2])
    s_ref, m_ref = torch.zeros(b, hw, n_refs), torch.zeros(b, hw, n_refs)
    for r in range(n_refs):
        sr = torch.zeros(b, hw)
        for j in range(tiles_per_ref):
            row = r * hw_key + j * bk
            s = q @ kp[:, row:row + bk].transpose(1, 2)            # (b, hw, bk)
            valid = hw_key - j * bk
            if valid < bk:
                s[..., valid:] = -math.inf
            m_new = torch.maximum(m, s.amax(-1) * LOG2E)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * LOG2E - m_new[..., None])
            l = alpha * l + p.sum(-1)
            sr = alpha * sr + p.sum(-1)
            o = alpha[..., None] * o + p @ vp[:, row:row + bk]
            m = m_new
        s_ref[..., r], m_ref[..., r] = sr, m
    out = o / l[..., None]
    c = xf.shape[2]
    vis = s_ref * torch.exp2(m_ref - m[..., None]) / l[..., None]
    return out[..., :c], (out[..., c:] if lf is not None else None), vis


def jax_xla(q, k, xf, lf):
    """The JAX generator's XLA attention (generator.py:308-322), one chunk."""
    energy = jnp.einsum("bnc,bqc->bnq", k, q)
    attn = jax.nn.softmax(energy, axis=1)
    out_x = jnp.einsum("bnc,bnq->bqc", xf, attn)
    out_l = jnp.einsum("bnc,bnq->bqc", lf, attn) if lf is not None else None
    return out_x, out_l, attn


@pytest.mark.parametrize("n_refs,hw_key,hw_q,has_lf", [
    (3, 143, 50, True),    # hw_key not a multiple of BK: masked tails
    (3, 143, 50, False),
    (5, 40, 48, True),     # hw_key < BK: every tile is a masked tail
    (5, 40, 48, False),
])
def test_emulated_walk_matches_jax_and_dense(rng, n_refs, hw_key, hw_q, has_lf):
    b, c = 2, 16
    q, k, xf, lf = inputs(rng, b, n_refs, hw_key, hw_q, c, has_lf)
    t = lambda a: None if a is None else torch.from_numpy(a)
    ex, el, evis = emulate_sm90(t(q), t(k), t(xf), t(lf), n_refs)
    j = lambda a: None if a is None else jnp.asarray(a)
    if hw_key % 8 == 0:
        jx, jl, jvis = jax_flash(j(q), j(k), j(xf), j(lf), n_refs=n_refs,
                                 q_block=16, k_block=16, interpret=True)
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


def test_emulated_walk_sharp_energies(rng):
    """Energies 4x sharper (std ~16 at c = 16): the running max moves by many
    units within a reference, and the recorded (s_r, m_r) still give the
    dense masses."""
    n_refs, hw_key, hw_q, c = 3, 143, 40, 16
    q, k, xf, lf = inputs(rng, 1, n_refs, hw_key, hw_q, c, True)
    q *= 4.0
    t = torch.from_numpy
    ex, el, evis = emulate_sm90(t(q), t(k), t(xf), t(lf), n_refs)
    dx, dl, dvis = dense(q, k, xf, lf, n_refs)
    np.testing.assert_allclose(ex.numpy(), dx, atol=1e-4)
    np.testing.assert_allclose(el.numpy(), dl, atol=1e-4)
    np.testing.assert_allclose(evis.numpy(), dvis, atol=1e-5)
