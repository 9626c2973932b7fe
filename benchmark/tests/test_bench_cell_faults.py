"""A whole run of a small pose cell on the CPU, past the harness's look for
a card: sound, `correct` comes out true; with each fault of
benchmark/cell_faults.py that the small cell shows, and with training's
faults, false.  The small cell is held to the real cell's limits.
`no_face_d_in_g` moves the small cell's directions less than the limits
(G 0.43, Gf 0.48 against 0.5); at the cell's size it reads 0.71-0.84
(PERF.md §2), and it is read there, on the card."""
from __future__ import annotations

import contextlib

import pytest

from benchmark import cell_faults, faults
from benchmark.run import run_cell

FAULTS = [None, "skip_refiner", "shifted_face_box", "unwarped_parts"] + list(faults.TRAIN)


@pytest.fixture(scope="module")
def pose_registry(tmp_path_factory):
    import torch
    from benchmark.registry import Registry
    from benchmark.tests.tiny import SMALL_G, make_root
    torch.set_num_threads(2)
    cells = {"tiny_pose.train": ("pose_refine.train_512x256_b4", SMALL_G,
                                 dict(batch=2, frames=3, size=64))}
    root = make_root(tmp_path_factory.mktemp("bench") / "root", cells)
    return Registry(root, root / "benchmark")


@pytest.mark.parametrize("fault", FAULTS, ids=[str(f) for f in FAULTS])
def test_pose_fault_turns_correct_false(pose_registry, fault):
    with (cell_faults.planted("train_pose", fault) if fault else contextlib.nullcontext()):
        result = run_cell(pose_registry, "tiny_pose.train", 2 ** 33 + 21, 2.0, False, "cpu",
                          started=0.0)
    assert result["correct"] is (fault is None), result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
