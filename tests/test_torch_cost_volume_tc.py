"""The port's tensor-core route of kernel B2 (csrc/cost_volume_tc.cu), as far
as the CPU can check it.

The kernel itself runs only on the card (chip_smoke.py holds it against the
plain version there).  Here:
  * the route rule of ops/cost_volume.py;
  * a pure-torch emulation of the kernel's arithmetic: per output row and
    vertical shift, the pixels split by parity, each parity a 16 x 8 NT
    product of the f1 row (channels padded to 32) with the f2 row segment of
    its parity, as m16n8k8 tf32 products (3xTF32 for f32 inputs: big = x
    truncated to tf32, small = x - big as the tensor cores read it, truncated
    to tf32 too, the products small.big + big.small + big.big, exact in f32
    and summed in f32), and the
    band of D displacements read out of it (the kernel walks the channels in
    chunks of 32, the emulation in one product: the same terms in another
    order).  It is held against the JAX Pallas kernel in interpret mode and
    the XLA `cost_volume` at the ragged shapes of
    tests/test_torch_cost_volume.py with that file's tolerance (1e-5 in
    f32), and for bf16 inputs (one product of exact values) against the f32
    result of the same bf16 values.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fsvid2vid_tpu.ops.cost_volume import cost_volume as jax_cost_volume
from fsvid2vid_tpu.ops.pallas.cost_volume_kernel import cost_volume_pallas
from fsvid2vid_tpu_torch.ops import cost_volume as cv
from fsvid2vid_tpu_torch.ops import cuda_build
from tests.test_torch_cost_volume import ATOL, CASES, nchw, nhwc


@pytest.mark.parametrize("device_type,md,stride,route", [
    ("cpu", 20, 2, "plain"),
    ("cuda", 20, 2, "tc"),      # the teacher's FlowNetC call
    ("cuda", 4, 2, "tc"),
    ("cuda", 5, 2, "tc"),       # displacement not a multiple of the stride
    ("cuda", 0, 2, "tc"),       # D = 1
    ("cuda", 24, 2, "tc"),      # D = 25, the widest the tc kernel takes
    ("cuda", 26, 2, "cuda_core"),
    ("cuda", 20, 1, "cuda_core"),
    ("cuda", 21, 3, "cuda_core"),
])
def test_tc_route_rule(device_type, md, stride, route):
    assert cv.route_for(device_type, md, stride) == route


def test_tc_kernel_has_its_own_build():
    assert isinstance(cv.KERNEL_TC, cuda_build.CudaLibrary)
    assert cv.KERNEL_TC.source == cuda_build.CSRC_DIR / "cost_volume_tc.cu"
    assert cv.KERNEL_TC.source.exists()
    assert cv.KERNEL_TC.library == cuda_build.BUILD_DIR / "libcost_volume_tc.so"


@pytest.mark.parametrize("launch", ["_launch_tc", "_launch_cuda_core"])
def test_launchers_refuse_cpu_tensors(launch):
    f1 = torch.zeros(1, 4, 6, 6)
    with pytest.raises(ValueError):
        getattr(cv, launch)(f1, f1.clone(), 4, 2)


def tf32(x):
    """f32 truncated to tf32 (10 explicit mantissa bits), as the kernel's
    split and the tensor cores' reading of an f32 register do."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def emulate_tc(f1, f2, md):
    """The tc kernel's arithmetic on (B, C, H, W) f32 tensors (bf16 inputs
    as their f32 values, one product) for stride 2."""
    b, c, h, w = f1.shape
    d = 2 * (md // 2) + 1
    r = d - 1
    nt = (15 + d + 7) // 8
    wc, cp = math.ceil(w / 32) * 32, math.ceil(c / 32) * 32
    split = f1.dtype == torch.float32
    f1p = F.pad(f1.float(), (0, wc - w, 0, 0, 0, cp - c))
    # f2 at column x' + R of the padded row is x' - R; rows padded by R
    f2p = F.pad(f2.float(), (r, wc - w + 16 * nt, r, r, 0, cp - c))

    def parts(x):
        big = tf32(x)
        return (big, tf32(x - big)) if split else (x, None)

    out = torch.zeros(b, d * d, h, w)
    for x0 in range(0, wc, 32):
        for par in (0, 1):
            a_big, a_small = parts(f1p[..., x0 + par:x0 + 32:2])            # (b, cp, h, 16)
            for dyi in range(d):
                seg = f2p[:, :, 2 * dyi:2 * dyi + h, x0 + par:x0 + par + 16 * nt:2]
                b_big, b_small = parts(seg)                                  # (b, cp, h, 8 nt)
                prod = lambda a_, b_: torch.einsum("bchi,bchu->bhiu", a_, b_)
                m = prod(a_big, b_big)
                if split:
                    m = prod(a_small, b_big) + prod(a_big, b_small) + m
                for i in range(16):
                    x = x0 + 2 * i + par
                    if x < w:
                        out[:, dyi * d:(dyi + 1) * d, :, x] = m[:, :, i, i:i + d].transpose(1, 2)
    return out * (1.0 / c)


@pytest.mark.parametrize("md,stride,shape", CASES)
def test_emulated_banded_product_matches_pallas_and_xla(rng, md, stride, shape):
    f1 = rng.randn(*shape).astype(np.float32)
    f2 = rng.randn(*shape).astype(np.float32)
    got = nhwc(emulate_tc(nchw(f1), nchw(f2), md))
    xla = np.asarray(jax_cost_volume(jnp.asarray(f1), jnp.asarray(f2), md, stride))
    np.testing.assert_allclose(got, xla, atol=ATOL)
    tile_h = 8 if shape[1] % 8 == 0 else 1
    pallas = np.asarray(cost_volume_pallas(jnp.asarray(f1), jnp.asarray(f2), md,
                                           stride, tile_h=tile_h, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=ATOL)


@pytest.mark.parametrize("md,shape", [(5, (1, 7, 9, 4)),      # R = 4 of max 5
                                      (8, (2, 5, 40, 33))])   # two 32-pixel chunks
def test_emulated_banded_product_other_grids(rng, md, shape):
    f1 = rng.randn(*shape).astype(np.float32)
    f2 = rng.randn(*shape).astype(np.float32)
    got = nhwc(emulate_tc(nchw(f1), nchw(f2), md))
    xla = np.asarray(jax_cost_volume(jnp.asarray(f1), jnp.asarray(f2), md, 2))
    np.testing.assert_allclose(got, xla, atol=ATOL)


def test_one_tf32_product_loses_what_the_split_keeps(rng):
    """Without the small parts, tf32 rounding of f32 inputs is visible
    against the 1e-5 tolerance at C = 256: the 3xTF32 split is needed."""
    f1 = nchw(rng.randn(1, 4, 8, 256).astype(np.float32))
    f2 = nchw(rng.randn(1, 4, 8, 256).astype(np.float32))
    exact = cv.cost_volume_plain(f1, f2, 4, 2)
    one = cv.cost_volume_plain(tf32(f1), tf32(f2), 4, 2)
    assert (one - exact).abs().max() > 1e-5
    assert (emulate_tc(f1, f2, 4) - exact).abs().max() <= 1e-6


def test_emulated_bf16_inputs_are_one_exact_product(rng):
    f1 = nchw(rng.randn(2, 9, 11, 40).astype(np.float32)).bfloat16()
    f2 = nchw(rng.randn(2, 9, 11, 40).astype(np.float32)).bfloat16()
    got = emulate_tc(f1, f2, 4)
    exact = cv.cost_volume_plain(f1.float(), f2.float(), 4, 2)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=1e-6)
