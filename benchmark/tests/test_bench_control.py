"""On the card: the control (the reference in fp8, benchmark/precision.py)
put in the program's place comes out not correct, while the program comes
out correct, at the small cells' sizes.  The readings the limits were set
from were taken at the cells' own sizes with `python -m benchmark.control`
(PERF.md)."""
from __future__ import annotations

import pytest

CELLS = ["tiny_face.serve", "tiny_street.serve", "tiny_street.train", "tiny_face.train"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(card, tiny_registry, cell):
    from benchmark.control import readings
    limits = tiny_registry.limits(cell)
    for seed in (2 ** 33 + 31, 2 ** 33 + 32, 2 ** 33 + 33):
        out = readings(tiny_registry, cell, seed, card, seconds=0.5)
        assert all(out["program"][k] <= v for k, v in limits.items()), out
        assert any(out["control"][k] > v for k, v in limits.items()), out
