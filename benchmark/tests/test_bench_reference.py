"""The reference is a plain copy of the port that agrees with the port's
plain paths, and the benchmark loads neither JAX nor the JAX package."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.run import ROOT, Run, forbidden_modules

BENCH = ROOT / "benchmark"
JAX = {"jax", "jaxlib", "flax", "fsvid2vid_tpu"}


def imported_tops(path: Path) -> set:
    """Top-level names of every module `path` imports, whole."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    bad = {str(p.relative_to(ROOT)): imported_tops(p) & JAX for p in files}
    assert not {k: v for k, v in bad.items() if v}
    # the port's name begins with the JAX package's: compared whole, it is
    # not the JAX package
    assert "fsvid2vid_tpu_torch" in imported_tops(BENCH / "drivers" / "serve.py")


def test_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert not imported_tops(path) & (JAX | {"fsvid2vid_tpu_torch"}), path


def test_a_run_process_loads_no_jax():
    code = ("import sys; import benchmark.run, benchmark.registry, benchmark.control, "
            "benchmark.drivers.serve, benchmark.drivers.train, benchmark.reference.inference.pipeline, "
            "benchmark.reference.training.loop, fsvid2vid_tpu_torch.training.trainer, "
            "fsvid2vid_tpu_torch.inference.pipeline; "
            "from benchmark.run import forbidden_modules; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fsvid2vid_tpu_torch_x", sys)
    assert "fsvid2vid_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in forbidden_modules()


def make_run(registry, name, seed, device="cpu", f32=True):
    cell = registry.cell(name)
    config = registry.config(cell["config"])
    if f32:
        config = dict(config, fields=dict(config["fields"], compute_dtype="float32"))
    return Run(torch=torch, device=torch.device(device), cell=cell, config=config,
               traffic=registry.traffic(cell["traffic"]), seed=seed, seconds=0.5,
               trace=False, started=0.0)


@pytest.mark.parametrize("cell", ["tiny_face.serve", "tiny_street.serve"])
def test_reference_frames_equal_the_port_in_f32(tiny_registry, cell):
    """The port's pipeline in f32 on the CPU (the plain attention) and the
    reference on the same weights and inputs serve the same frames."""
    run = make_run(tiny_registry, cell, 2 ** 33 + 11)
    out = tiny_registry.driver("serve").control(run, fp8=False)
    assert out["program"]["frame_max_gap"] <= 1e-5
    assert out["program"]["ref_idx_flips"] == 0


@pytest.mark.parametrize("cell", ["tiny_street.train", "tiny_face.train"])
def test_reference_steps_equal_the_port_in_f32(tiny_registry, cell):
    """Three train steps of the port's trainer in f32 (plain attention and
    correlation) and of the reference: losses, first gradients and changes."""
    run = make_run(tiny_registry, cell, 2 ** 33 + 12)
    out = tiny_registry.driver("train").control(run, fp8=False)["program"]
    assert max(out.values()) <= 1e-4, out


def test_fp8_control_rounds_products_and_activations():
    from benchmark.precision import Fp8Operands, round_fp8
    x = torch.linspace(-3, 3, 101).reshape(1, 101)
    q = round_fp8(x)
    assert (q - x).abs().max() > 0 and (q - x).abs().max() <= 3 * 2 ** -4
    assert torch.equal(round_fp8(q), q)
    w = torch.randn(5, 101, requires_grad=True)
    with Fp8Operands():
        y = torch.nn.functional.linear(x, w)
        y.sum().backward()
    assert not torch.equal(y, x @ w.t())
    assert torch.allclose(y, round_fp8(x) @ round_fp8(w).t(), rtol=0.13, atol=0.5)
    assert w.grad is not None and torch.isfinite(w.grad).all()
