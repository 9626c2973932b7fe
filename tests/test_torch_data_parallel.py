"""Data parallel over ranks (fsvid2vid_tpu_torch/parallel/) on the CPU: two
gloo ranks against one process, through `dryrun_data_parallel`, the
PyTorch counterpart of __graft_entry__.py's `dryrun_multichip`.

Each case splits one global batch of 2 over two child processes (one
sample each), which meet through a FileStore in the test's temporary
directory; every collective has a timeout and the run a deadline, so a hang
fails the test.  Each step's losses must equal those of the same step in
one process, from the same weights, buffers and Adam moments, within JAX's
dryrun tolerances (the JAX dryrun asks the temporal step only for finite
losses); the first step's frames must equal within 1e-4; after both steps
every parameter, buffer and Adam moment is bitwise equal across the ranks.
The one-process step is held against JAX's by tests/test_torch_train_step.py
(and the VAE + concat one by test_torch_kld_concat_step.py).

Cases: the default step, `step_mode='faithful'` (JAX
tests/test_train_step.py:150), and the VAE with `use_label_ref='concat'`
(lambda_kld 1): its KL term sums over the batch, and each rank takes its
rows of the global batch's noise.
"""
import math

import pytest
import torch

from fsvid2vid_tpu_torch.parallel import mesh
from fsvid2vid_tpu_torch.parallel.dryrun import (
    TIGHT, dryrun_data_parallel, loss_tolerance)
from tests.test_torch_data import few_threads  # noqa: F401 (autouse)

CASES = {"default": {}, "faithful": dict(step_mode="faithful"),
         "vae_concat": dict(lambda_kld=1.0, use_label_ref="concat")}


@pytest.mark.parametrize("case", list(CASES))
def test_two_gloo_ranks_equal_one_process(case, tmp_path):
    report = dryrun_data_parallel(2, "cpu", "gloo", work_dir=str(tmp_path), timeout_s=60,
                                  deadline_s=240, **CASES[case])
    single, ranks = report["single"], report["ranks"]
    assert [r["rows"] for r in ranks] == [[0, 1], [1, 2]] and single["rows"] == [0, 2]
    assert len(single["losses"]) == len(ranks[0]["losses"]) == 2
    first = single["losses"][0]
    for t, losses in enumerate(single["losses"]):
        assert all(report["diff"][t][k] <= loss_tolerance(k, a) for k, a in losses.items())
        assert all(math.isfinite(v) for v in ranks[0]["losses"][t].values())
    assert set(TIGHT) <= set(first)
    assert ranks[0]["n_tensors"] == ranks[1]["n_tensors"] == single["n_tensors"] > 100
    if case == "vae_concat":
        # the global sum of the KL term, not the ranks' mean of their sums
        assert first["G_KLD"] > 0
        assert report["diff"][0]["G_KLD"] <= 1e-4 * first["G_KLD"]
    assert not mesh.is_initialized()   # the ranks are processes of their own


def test_one_process_is_a_world_of_one():
    """Outside a group every helper leaves the single-device step as it was."""
    assert mesh.world() == 1 and mesh.rank() == 0 and mesh.is_master()
    assert mesh.local_rows(4) == slice(0, 4)
    t = torch.ones(3)
    assert mesh.all_reduce_sum(t) is t and torch.equal(mesh.all_reduce_mean(t), t)
    assert mesh.rank_device(torch.device("cpu")) == torch.device("cpu")
    assert mesh.backend_for(torch.device("cpu")) == "gloo"
    assert mesh.backend_for(torch.device("cuda", 0)) == "nccl"
    assert mesh.init_url("host:29500") == "tcp://host:29500"
    assert mesh.init_url("file:///tmp/store") == "file:///tmp/store"
