"""The port's correlation cost volume against the JAX package, on the CPU.

On a CPU tensor the port's `correlation` runs its plain PyTorch version (the
CUDA kernel runs only on the card, where chip_smoke.py holds it against the
same plain version).  Here the plain version is compared with the JAX Pallas
kernel in interpret mode and with the XLA shift-and-reduce `cost_volume`, and
the backward with `jax.grad` of the JAX `correlation`.  The port is NCHW,
the JAX functions NHWC: arrays are transposed at the test's edge.

Tolerance 1e-5 in f32 (the same f32 products, summed over channels in
another order, on inputs of order one); for bf16 inputs 2e-2: both sides
accumulate in f32 and round the result, of magnitude below 4, to bf16
(half a bf16 ulp below 4 is 8e-3), but XLA on the CPU may form the products
in bf16.
"""
import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.ops.cost_volume import correlation as jax_correlation
from fsvid2vid_tpu.ops.cost_volume import cost_volume as jax_cost_volume
from fsvid2vid_tpu.ops.pallas.cost_volume_kernel import cost_volume_pallas
from fsvid2vid_tpu_torch.ops import attention_kernel as ak
from fsvid2vid_tpu_torch.ops import cost_volume as cv
from fsvid2vid_tpu_torch.ops import cuda_build

ATOL = 1e-5
ATOL_BF16 = 2e-2


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


# (max_displacement, stride, (B, H, W, C)); H and W are not multiples of 8,
# and the 3 x 5, 13 x 19, 6 x 7, 5 x 4, 5 x 6 and 4 x 6 maps are smaller
# than the displacement
CASES = [(4, 2, (2, 9, 11, 8)), (4, 2, (1, 3, 5, 7)), (20, 2, (1, 13, 19, 6)),
         (20, 2, (2, 8, 8, 16)),
         (4, 1, (2, 9, 11, 8)),      # D = 9, PWC-Net's search range
         (20, 1, (1, 6, 7, 3)),      # D = 41
         (21, 3, (1, 13, 19, 6)),    # D = 15
         (12, 4, (1, 8, 70, 5)),     # D = 7 over two spans of 64 pixels
         (9, 3, (2, 5, 4, 4)),       # R = 9 past both edges of the map
         (5, 3, (1, 7, 9, 5)),       # md not a multiple of the stride: R = 3
         (7, 4, (1, 9, 13, 4)),      # R = 4
         (32, 1, (1, 5, 6, 3)),      # D = 65
         (40, 1, (1, 4, 6, 3))]      # D = 81
# The Pallas kernel in interpret mode takes ~10 s at D = 41 and ~26 s at
# D = 81 on these maps, so it is compared up to D = 41.  Its vertical grid
# starts at -md where md is not a multiple of the stride (its f2 band is
# padded by md and shifted by dy_idx * stride), so there it is not compared:
# the XLA function, which the port follows, starts at -R.
PALLAS_MAX_D = 41


def pallas_compares(md, stride):
    return 2 * (md // stride) + 1 <= PALLAS_MAX_D and md % stride == 0


@pytest.mark.parametrize("md,stride,shape", CASES)
def test_plain_matches_pallas_interpret_and_xla(rng, md, stride, shape):
    f1 = rng.randn(*shape).astype(np.float32)
    f2 = rng.randn(*shape).astype(np.float32)
    got = nhwc(cv.cost_volume_plain(nchw(f1), nchw(f2), md, stride))
    d = 2 * (md // stride) + 1
    assert got.shape == shape[:3] + (d * d,)
    xla = np.asarray(jax_cost_volume(jnp.asarray(f1), jnp.asarray(f2), md, stride))
    np.testing.assert_allclose(got, xla, atol=ATOL)
    if pallas_compares(md, stride):
        tile_h = 8 if shape[1] % 8 == 0 else 1
        pallas = np.asarray(cost_volume_pallas(jnp.asarray(f1), jnp.asarray(f2), md,
                                               stride, tile_h=tile_h, interpret=True))
        np.testing.assert_allclose(got, pallas, atol=ATOL)


def test_displacement_not_a_multiple_of_stride(rng):
    """max_displacement 5, stride 2: the grid is {-4, ..., 4}, as in the XLA
    reference."""
    f1 = rng.randn(1, 7, 9, 4).astype(np.float32)
    f2 = rng.randn(1, 7, 9, 4).astype(np.float32)
    got = nhwc(cv.cost_volume_plain(nchw(f1), nchw(f2), 5, 2))
    xla = np.asarray(jax_cost_volume(jnp.asarray(f1), jnp.asarray(f2), 5, 2))
    assert got.shape == (1, 7, 9, 25)
    np.testing.assert_allclose(got, xla, atol=ATOL)


def test_bf16_inputs(rng):
    f1 = rng.randn(2, 9, 11, 8).astype(np.float32)
    f2 = rng.randn(2, 9, 11, 8).astype(np.float32)
    out = cv.correlation(nchw(f1).bfloat16(), nchw(f2).bfloat16(), 4, 2)
    assert out.dtype == torch.bfloat16
    xla = jax_cost_volume(jnp.asarray(f1, jnp.bfloat16),
                          jnp.asarray(f2, jnp.bfloat16), 4, 2)
    assert xla.dtype == jnp.bfloat16
    np.testing.assert_allclose(nhwc(out), np.asarray(xla.astype(jnp.float32)),
                               atol=ATOL_BF16)
    # against the f32 result of the bf16-rounded inputs: one rounding of the output
    r = lambda a: nchw(a).bfloat16().float()
    exact = cv.cost_volume_plain(r(f1), r(f2), 4, 2)
    np.testing.assert_allclose(out.float().numpy(), exact.numpy(), atol=ATOL_BF16)


@pytest.mark.parametrize("md,stride,shape", [(4, 2, (1, 8, 12, 4)),
                                             (20, 2, (2, 5, 7, 3)),
                                             (4, 1, (1, 6, 7, 4)),
                                             (6, 3, (1, 7, 8, 3))])
def test_backward_matches_jax_grad(rng, md, stride, shape):
    d = 2 * (md // stride) + 1
    f1 = rng.randn(*shape).astype(np.float32)
    f2 = rng.randn(*shape).astype(np.float32)
    cot = rng.randn(*shape[:3], d * d).astype(np.float32)

    def loss(a, b):
        return (jax_correlation(a, b, md, stride, interpret=True)
                * jnp.asarray(cot)).sum()

    g1, g2 = jax.grad(loss, argnums=(0, 1))(jnp.asarray(f1), jnp.asarray(f2))
    t1, t2 = nchw(f1).requires_grad_(), nchw(f2).requires_grad_()
    (cv.correlation(t1, t2, md, stride) * nchw(cot)).sum().backward()
    np.testing.assert_allclose(nhwc(t1.grad), np.asarray(g1), atol=ATOL)
    np.testing.assert_allclose(nhwc(t2.grad), np.asarray(g2), atol=ATOL)


def test_backward_matches_autograd_of_plain(rng):
    f1 = torch.from_numpy(rng.randn(2, 3, 6, 7).astype(np.float32))
    f2 = torch.from_numpy(rng.randn(2, 3, 6, 7).astype(np.float32))
    cot = torch.from_numpy(rng.randn(2, 25, 6, 7).astype(np.float32))
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    (cv.cost_volume_plain(a, b, 4, 2) * cot).sum().backward()
    g1, g2 = cv.cost_volume_backward_plain(f1, f2, cot, 4, 2)
    np.testing.assert_allclose(g1.numpy(), a.grad.numpy(), atol=ATOL)
    np.testing.assert_allclose(g2.numpy(), b.grad.numpy(), atol=ATOL)


def test_cpu_call_takes_the_plain_version_and_counts_no_launch(rng):
    f1 = torch.from_numpy(rng.randn(1, 4, 6, 6).astype(np.float32))
    f2 = torch.from_numpy(rng.randn(1, 4, 6, 6).astype(np.float32))
    before = cv.cost_volume_cuda.launches
    got = cv.correlation(f1, f2, 4, 2)
    assert cv.cost_volume_cuda.launches == before
    assert torch.equal(got, cv.cost_volume_plain(f1, f2, 4, 2))


@pytest.mark.parametrize("case", ["cpu_tensor", "shape", "dtype", "rank",
                                  "stride", "mixed_dtype"])
def test_wrapper_rejects(case):
    f1 = torch.zeros(1, 4, 6, 6)
    f2 = torch.zeros(1, 4, 6, 6)
    kw = {}
    fn = cv.cost_volume_cuda
    if case == "shape":
        f2 = torch.zeros(1, 4, 6, 5)
    elif case == "dtype":
        f1, f2 = f1.half(), f2.half()
    elif case == "rank":
        f1, f2 = f1[0], f2[0]
    elif case == "stride":
        kw = dict(stride=0)
    elif case == "mixed_dtype":
        f2 = f2.bfloat16()
    if case != "cpu_tensor":
        fn = cv.correlation
    with pytest.raises(ValueError):
        fn(f1, f2, **kw)


# ----------------------------------------------------------------------
# the build helper both kernels share
# ----------------------------------------------------------------------
def _fake_nvcc(tmp_path, body):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return bindir


def test_both_kernels_share_one_build_helper():
    assert isinstance(ak.KERNEL_SM90, cuda_build.CudaLibrary)
    assert isinstance(cv.KERNEL_TC, cuda_build.CudaLibrary)
    for lib, name in ((ak.KERNEL_SM90, "flash_ref_attention_sm90"),
                      (cv.KERNEL_TC, "cost_volume_tc")):
        assert lib.source == cuda_build.CSRC_DIR / f"{name}.cu"
        assert lib.source.exists()
        assert lib.library == cuda_build.BUILD_DIR / f"lib{name}.so"
    assert cuda_build.BUILD_DIR.name == "build"
    assert cuda_build.BUILD_DIR.parent.name == "fsvid2vid_tpu_torch"


def test_build_compiles_for_sm_90a_into_the_build_dir(tmp_path, monkeypatch):
    # a stand-in compiler that records its arguments and writes the output
    bindir = _fake_nvcc(tmp_path, 'echo "$@" > "%s"\n'
                        'while [ "$1" != "-o" ]; do shift; done\necho lib > "$2"\n'
                        % (tmp_path / "args"))
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    lib = cuda_build.CudaLibrary("cost_volume_tc", lambda lib: None)
    assert lib.library.parent == tmp_path / "build"
    seconds, _ = lib.build(verbose=True)
    args = (tmp_path / "args").read_text().split()
    assert "arch=compute_90a,code=sm_90a" in args and "-shared" in args
    assert args[-1] == str(lib.source) and "-v" in args
    assert lib.library.read_text() == "lib\n" and seconds >= 0
    assert os.listdir(tmp_path / "build") == ["libcost_volume_tc.so"]


def test_header_newer_than_library_marks_it_out_of_date(tmp_path, monkeypatch):
    """A library is rebuilt when its source or any csrc/*.cuh header (which
    the source may include) is newer than it."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    lib = cuda_build.CudaLibrary("kern", lambda lib: None)
    assert lib.source == csrc / "kern.cu"
    header = csrc / "common.cuh"
    for path in (lib.source, header):
        path.write_text("//\n")
        os.utime(path, (100, 100))
    assert lib.out_of_date()                      # no library yet
    lib.library.parent.mkdir()
    lib.library.write_text("lib\n")
    os.utime(lib.library, (200, 200))
    assert not lib.out_of_date()
    os.utime(header, (300, 300))                  # the header alone changed
    assert lib.out_of_date()
    os.utime(lib.library, (400, 400))
    assert not lib.out_of_date()
    os.utime(lib.source, (500, 500))
    assert lib.out_of_date()


def test_failed_build_raises_and_leaves_nothing(tmp_path, monkeypatch):
    bindir = _fake_nvcc(tmp_path, "echo broken >&2\nexit 3\n")
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    lib = cuda_build.CudaLibrary("cost_volume_tc", lambda lib: None)
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*broken"):
        lib.load()
    assert os.listdir(tmp_path / "build") == []


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.CudaLibrary("cost_volume_tc", lambda lib: None).build()
