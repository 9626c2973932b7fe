"""The port's kernel B2 on the tensor cores (csrc/cost_volume_tc.cu), as far
as the CPU can check it.

The kernel itself runs only on the card (chip_smoke.py holds it against the
plain version there).  Here:
  * the route rule of ops/cost_volume.py: every CUDA grid takes "tc";
  * `tc_plan`, the mirror of the kernel's tiling (its constants read from
    the source): every grid up to md 64 and stride 8 fits a block's shared
    memory and the register tiles, its windows cover the D shifts;
  * a pure-torch emulation of the kernel's arithmetic: per output row and
    vertical shift, the pixels split into classes of 16 at step s (two a
    block), each class a 16 x 8 NT product of its f1 pixels (channels padded
    to 32) with its f2 columns in each window of horizontal shifts, as
    m16n8k8 tf32 products (3xTF32 for f32 inputs: big = x truncated to
    tf32, small = x - big as the tensor cores read it, truncated to tf32
    too, the products small.big + big.small + big.big, exact in f32 and
    summed in f32), and the band of the window's shifts read out of it (the
    kernel walks the channels in chunks of 32, the emulation in one product:
    the same terms in another order).  It is held against the JAX Pallas
    kernel in interpret mode and the XLA `cost_volume` at the shapes of
    tests/test_torch_cost_volume.py (strides 1-4, D up to 81; the Pallas
    kernel where that file compares it) with that file's tolerance (1e-5 in
    f32), and for bf16 inputs (one product of exact values) against the f32
    result of the same bf16 values.
"""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fsvid2vid_tpu.ops.cost_volume import cost_volume as jax_cost_volume
from fsvid2vid_tpu.ops.pallas.cost_volume_kernel import cost_volume_pallas
from fsvid2vid_tpu_torch.ops import cost_volume as cv
from fsvid2vid_tpu_torch.ops import cuda_build
from tests.test_torch_cost_volume import ATOL, CASES, nchw, nhwc, pallas_compares


@pytest.mark.parametrize("device_type,md,stride,route", [
    ("cpu", 20, 2, "plain"),
    ("cpu", 32, 1, "plain"),
    ("cuda", 20, 2, "tc"),      # the teacher's FlowNetC call
    ("cuda", 4, 2, "tc"),
    ("cuda", 5, 2, "tc"),       # displacement not a multiple of the stride
    ("cuda", 0, 2, "tc"),       # D = 1
    ("cuda", 24, 2, "tc"),      # D = 25, one window
    ("cuda", 26, 2, "tc"),      # D = 27, two windows
    ("cuda", 20, 1, "tc"),
    ("cuda", 21, 3, "tc"),
    ("cuda", 32, 1, "tc"),      # D = 65, three windows
    ("cuda", 40, 1, "tc"),      # D = 81
])
def test_tc_route_rule(device_type, md, stride, route):
    assert cv.route_for(device_type, md, stride) == route


def test_tc_kernel_has_its_own_build():
    assert isinstance(cv.KERNEL_TC, cuda_build.CudaLibrary)
    assert cv.KERNEL_TC.source == cuda_build.CSRC_DIR / "cost_volume_tc.cu"
    assert cv.KERNEL_TC.source.exists()
    assert cv.KERNEL_TC.library == cuda_build.BUILD_DIR / "libcost_volume_tc.so"


@pytest.mark.parametrize("md,stride", [(4, 2), (32, 1), (40, 1)])
def test_launchers_refuse_cpu_tensors(md, stride):
    """What the launcher refuses here is the device, whatever the grid;
    the tc kernel takes D = 65 and 81 on the card (C.4)."""
    f1 = torch.zeros(1, 4, 6, 6)
    with pytest.raises(ValueError, match="not CUDA"):
        cv._launch_tc(f1, f1.clone(), md, stride)


def _source_constants():
    src = cv.KERNEL_TC.source.read_text()
    return {name: int(value) for name, value in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_plan_constants_are_the_kernels():
    k = _source_constants()
    assert (k["TX"], k["CLASS_PX"], k["SLOTS"], k["MAX_NT"]) == (
        cv.TC_PIXELS, cv.TC_CLASS_PX, cv.TC_SLOTS, cv.TC_MAX_NT)
    assert k["CC"] + 4 == cv.TC_CS and cv.TC_MAX_DW == 25


@pytest.mark.parametrize("stride", range(1, 9))
def test_plan_fits_every_grid(stride):
    """md <= 64 at strides 1-8 (and md 400 at stride 1, D = 801): two blocks'
    shared memory fit an SM (each block's under the 232,448-byte limit, with
    1 KB the card reserves per block), the register tiles (NT <= 5) hold
    the window, and the windows cover the D shifts, none empty."""
    for md in list(range(65)) + ([400] if stride == 1 else []):
        p = cv.tc_plan(md, stride, 32)
        assert p.d == 2 * (md // stride) + 1 and p.radius == md // stride * stride
        assert 2 * (p.smem_bytes + 1024) <= 233472 and p.smem_bytes <= cv.SMEM_LIMIT
        assert p.n_tiles <= cv.TC_MAX_NT and 8 * p.n_tiles >= 15 + p.window_d
        assert p.window_d <= cv.TC_MAX_DW
        assert (p.windows - 1) * p.window_d < p.d <= p.windows * p.window_d
        assert p.windows == (1 if p.d <= 25 else math.ceil(p.d / 25))


def test_plan_keeps_the_teachers_tiling():
    """Stride 2, md 20 (every flow-teacher call): one window of the 21 shifts,
    5 n8 tiles, a block per 32 pixels: the parity design's tiling."""
    p = cv.tc_plan(20, 2, 64)
    assert (p.windows, p.window_d, p.n_tiles, p.x_blocks) == (1, 21, 5, 2)
    assert p.smem_bytes == 4 * (2 * (32 + 4 * 16 * 5) * 36 + 4 * 21 * 32)


@pytest.mark.parametrize("md,stride,width,x_blocks", [
    (4, 1, 32, 1), (4, 1, 33, 2), (20, 1, 32, 2),     # two windows at D = 41
    (21, 3, 48, 2), (21, 3, 49, 3), (12, 4, 70, 4), (40, 1, 19, 4)])
def test_plan_blocks_along_a_row(md, stride, width, x_blocks):
    """s * ceil(W / 16 s) classes, two a block, times the windows."""
    assert cv.tc_plan(md, stride, width).x_blocks == x_blocks


def test_plan_refuses_what_the_kernel_refuses():
    for md, stride in ((-1, 2), (4, 0)):
        with pytest.raises(ValueError):
            cv.tc_plan(md, stride)


def tf32(x):
    """f32 truncated to tf32 (10 explicit mantissa bits), as the kernel's
    split and the tensor cores' reading of an f32 register do."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def emulate_tc(f1, f2, md, stride=2):
    """The tc kernel's arithmetic on (B, C, H, W) f32 tensors (bf16 inputs
    as their f32 values, one product), with its classes and windows from
    `tc_plan`."""
    b, c, h, w = f1.shape
    plan = cv.tc_plan(md, stride, w)
    d, r = plan.d, plan.radius
    cp = math.ceil(c / 32) * 32
    split = f1.dtype == torch.float32
    f1p = F.pad(f1.float(), (0, 0, 0, 0, 0, cp - c))
    f2p = F.pad(f2.float(), (0, 0, r, r, 0, cp - c))   # f2 row y' at y' + R

    def columns(t, xs):   # t[..., xs], zeros outside the map
        xs = torch.tensor(xs)
        return t[..., xs.clamp(0, w - 1)] * ((xs >= 0) & (xs < w))

    def parts(x):
        big = tf32(x)
        return (big, tf32(x - big)) if split else (x, None)

    def prod(a_, b_):
        return torch.einsum("bchi,bchu->bhiu", a_, b_)

    out = torch.zeros(b, d * d, h, w)
    for cls in range(2 * plan.x_blocks // plan.windows):   # the row's classes, two a block
        first = cv.tc_class_first(cls, stride)
        if first >= w:
            continue   # no pixel in the map: the kernel's warp does no products
        xs = [first + stride * i for i in range(16)]
        a_big, a_small = parts(columns(f1p, xs))                              # (b, cp, h, 16)
        for win in range(plan.windows):
            w0 = win * plan.window_d
            dw = min(plan.window_d, d - w0)
            cols = [first - r + stride * (w0 + j) for j in range(8 * plan.n_tiles)]
            for dyi in range(d):
                b_big, b_small = parts(columns(f2p[:, :, stride * dyi:stride * dyi + h], cols))
                m = prod(a_big, b_big)
                if split:
                    m = prod(a_small, b_big) + prod(a_big, b_small) + m
                for i, x in enumerate(xs):
                    if x < w:
                        out[:, dyi * d + w0:dyi * d + w0 + dw, :, x] = \
                            m[:, :, i, i:i + dw].transpose(1, 2)
    return out * (1.0 / c)


@pytest.mark.parametrize("md,stride,shape", CASES)
def test_emulated_banded_product_matches_pallas_and_xla(rng, md, stride, shape):
    f1 = rng.randn(*shape).astype(np.float32)
    f2 = rng.randn(*shape).astype(np.float32)
    got = nhwc(emulate_tc(nchw(f1), nchw(f2), md, stride))
    xla = np.asarray(jax_cost_volume(jnp.asarray(f1), jnp.asarray(f2), md, stride))
    np.testing.assert_allclose(got, xla, atol=ATOL)
    if pallas_compares(md, stride):
        tile_h = 8 if shape[1] % 8 == 0 else 1
        pallas = np.asarray(cost_volume_pallas(jnp.asarray(f1), jnp.asarray(f2), md,
                                               stride, tile_h=tile_h, interpret=True))
        np.testing.assert_allclose(got, pallas, atol=ATOL)


@pytest.mark.parametrize("md,stride,shape", [
    (5, 2, (1, 7, 9, 4)),      # R = 4 of max 5
    (8, 2, (2, 5, 40, 33)),    # two 32-pixel blocks
    (26, 2, (1, 4, 30, 3)),    # D = 27 in two windows of 14
    (3, 1, (1, 3, 40, 3)),     # three classes of 16 in two blocks
    (5, 3, (1, 6, 50, 3)),     # three residues over two spans of 48
    (24, 8, (1, 3, 140, 2))])  # eight residues, a class wholly past W
def test_emulated_banded_product_other_grids(rng, md, stride, shape):
    f1 = rng.randn(*shape).astype(np.float32)
    f2 = rng.randn(*shape).astype(np.float32)
    got = nhwc(emulate_tc(nchw(f1), nchw(f2), md, stride))
    xla = np.asarray(jax_cost_volume(jnp.asarray(f1), jnp.asarray(f2), md, stride))
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


@pytest.mark.parametrize("md,stride", [(4, 2), (20, 1), (6, 3)])
def test_emulated_bf16_inputs_are_one_exact_product(rng, md, stride):
    f1 = nchw(rng.randn(2, 9, 11, 40).astype(np.float32)).bfloat16()
    f2 = nchw(rng.randn(2, 9, 11, 40).astype(np.float32)).bfloat16()
    got = emulate_tc(f1, f2, md, stride)
    exact = cv.cost_volume_plain(f1.float(), f2.float(), md, stride)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=1e-6)
