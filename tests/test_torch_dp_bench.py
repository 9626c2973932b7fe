"""The benchmark's data-parallel traffic (train_256_dp4, the face training
cell on four cards) on the CPU: its driver (benchmark/drivers/train_dp.py)
at a tiny face size on two gloo ranks, this process rank 0 and the other a
child, through the harness's run: sound, `correct` with every rank's
parameters bitwise rank 0's; with one rank keeping its own gradients
(benchmark/cell_faults.py), not.  The faults reaching every rank through
the environment; the port's all-reduce span and byte counter
(parallel/mesh.py) on rank 0."""
from __future__ import annotations

import contextlib
import json

import pytest
import torch

from benchmark import cell_faults
from benchmark.registry import Registry
from benchmark.run import run_cell
from fsvid2vid_tpu_torch.parallel import mesh
from fsvid2vid_tpu_torch.utils import profiling
from tests.test_torch_data import few_threads  # noqa: F401 (autouse)

CELL = "face_k8.train_256_b4"      # the one-card cell the traffic spreads over ranks
SMALL_G = dict(ngf=8, nff=8, ndf=8, n_blocks_F=2, n_downsample_G=3, n_adaptive_layers=2)


@pytest.fixture(scope="module")
def tiny_registry(tmp_path_factory):
    """The traffic at 64 px, K = 3, a global batch of 4 on two ranks, T = 3,
    one set-up sequence, with the data-parallel limits."""
    from benchmark.tests.tiny import make_root
    cells = {"tiny_dp.train": (CELL, dict(SMALL_G, n_shot=3),
                               dict(batch=4, frames=3, size=64, cells=[8, 8]))}
    root = make_root(tmp_path_factory.mktemp("bench") / "root", cells)
    bench = root / "benchmark"
    tiny = json.loads((bench / "traffic" / "tiny_tiny_dp_train.json").read_text())
    dp = json.loads((bench / "traffic" / "train_256_dp4.json").read_text())
    dp.update(config_fields=tiny["config_fields"], frames=tiny["frames"], ranks=2,
              labels=tiny["labels"], image_cells=tiny["image_cells"], warmup_sequences=1)
    (bench / "traffic" / "tiny_tiny_dp_train.json").write_text(json.dumps(dp))
    (bench / "limits" / "tiny_dp.train.json").write_text(
        (bench / "limits" / "face_k8.train_256_dp4.json").read_text())
    return Registry(root, root / "benchmark")


@pytest.mark.parametrize("fault", [None, "rank_skips_average"])
def test_dp_run_is_correct_and_catches_a_rank_left_out(tiny_registry, fault):
    profiling.clear()
    before = mesh.all_reduce_grads.bytes
    was = profiling.record(True)
    try:
        with (cell_faults.planted("train_dp", fault) if fault else contextlib.nullcontext()):
            result = run_cell(tiny_registry, "tiny_dp.train", 2 ** 33 + 29, 0.0, False, "cpu",
                              started=0.0)
        records = profiling.spans()
    finally:
        profiling.record(was)
        profiling.clear()
    assert not mesh.is_initialized()
    compared = {k: v["value"] for k, v in result["compared"].items()}
    assert result["correct"] is (fault is None), compared
    assert result["attempted"] == 4 * 3 and result["failed"] == 0
    if fault is None:
        assert compared["rank_gap"] == 0.0
    else:
        assert compared["rank_gap"] > 0.01
    # rank 0's two all-reduces a step, under its updates, with their bytes
    parents = [records[r.parent].name for r in records if r.name == "fsv.train.all_reduce"]
    assert parents and set(parents) == {"fsv.train.update_D", "fsv.train.update_G"}
    assert len(parents) == 2 * sum(r.name == "fsv.train.step" for r in records)
    assert mesh.all_reduce_grads.bytes > before


@pytest.mark.parametrize("rank", [0, 1])
def test_training_faults_reach_every_rank_through_the_environment(rank):
    """A training fault planted for the data-parallel traffic is named in
    the environment, which the children inherit, and each rank plants it
    in its own process before it builds the program; the rank fault only
    in the last rank."""
    import fsvid2vid_tpu_torch.training.trainer as trainer_mod
    from benchmark.drivers import train_dp
    step = trainer_mod.train_step
    with cell_faults.planted("train_dp", "half_batch"):
        with train_dp.planted_fault(rank, 2):
            assert trainer_mod.train_step is not step
    assert trainer_mod.train_step is step
    reduce = mesh.all_reduce_grads
    with cell_faults.planted("train_dp", "rank_skips_average"):
        with train_dp.planted_fault(rank, 2):
            assert (mesh.all_reduce_grads is not reduce) is (rank == 1)
    assert mesh.all_reduce_grads is reduce
