"""Fixtures of the benchmark's own tests (run them with
`python -m pytest benchmark/tests`).  Tests that need the card carry the
`card` marker and take the `card` fixture, which skips them on a host
without CUDA; the decision is made inside the fixture, never at import."""
from __future__ import annotations

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skipped on a host without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with the small cells of tiny.py beside the
    real ones."""
    from benchmark.tests.tiny import make_root
    return make_root(tmp_path_factory.mktemp("bench") / "root")


@pytest.fixture(scope="session")
def tiny_registry(tiny_root):
    """The small cells' registry; torch keeps to two threads, so that test
    workers side by side do not crowd the host's cores."""
    import torch
    from benchmark.registry import Registry
    torch.set_num_threads(2)
    return Registry(tiny_root, tiny_root / "benchmark")
