"""A whole run of each small cell on the CPU, past the harness's look for a
card: sound, `correct` comes out true; with each fault the cell can have
planted underneath (benchmark/faults.py), false.  The small cells are held
to the real cells' limits."""
from __future__ import annotations

import pytest

from benchmark import faults
from benchmark.run import run_cell

CASES = ([("tiny_face.serve", f) for f in (None,) + faults.SERVE]
         + [("tiny_street.serve", f) for f in (None,) + faults.SERVE]
         + [("tiny_street.train", f) for f in (None,) + faults.TRAIN]
         + [("tiny_face.train", f) for f in (None,) + faults.TRAIN])


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_turns_correct_false(tiny_registry, cell, fault):
    kind = tiny_registry.traffic(tiny_registry.cell(cell)["traffic"])["kind"]
    with faults.planted(kind, fault) if fault else _nothing():
        result = run_cell(tiny_registry, cell, 2 ** 33 + 21, 3.0, False, "cpu", started=0.0)
    assert result["correct"] is (fault is None), result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "compared"


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
