"""`cli.train` data parallel over two processes on the CPU: `--distributed
--coordinator_address file://... --num_processes 2 --process_id i --device
cpu` on a synthetic face dataset, each rank a child process that runs the
CLI's `main` and writes what it ended with (a digest of every parameter,
buffer and Adam moment, and the files it saved with torch.save).

Rank 0 alone writes the checkpoint, both ranks end bitwise equal, and a
second run with --continue_train resumes both ranks from that checkpoint.
The ranks meet through a FileStore under the test's temporary directory
(no TCP port, as pytest-xdist's workers share the host), and the run has a
deadline: a rank that hangs is killed and fails the test.
"""
import json
import os
import subprocess
import sys
import time

import pytest

from tests.test_torch_cli import REPO, train_argv
from tests.test_torch_data import TORCH_THREADS, write_face_dataset

DEADLINE = 240
CHILD = r"""
import json, sys
import torch
saved = []
_save = torch.save
def save(obj, f, *a, **kw):
    saved.append(str(f))
    return _save(obj, f, *a, **kw)
torch.save = save
from fsvid2vid_tpu_torch.cli import train
from fsvid2vid_tpu_torch.parallel.dryrun import state_digests
run = train.main(sys.argv[2:])
with open(sys.argv[1], "w") as f:
    json.dump({"saved": saved, "digests": state_digests(run.trainer.state),
               "start_epoch": run.trainer.start_epoch, "step": run.trainer.state.step,
               "shard": [run.loader.shard_id, run.loader.num_shards]}, f)
"""


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_face_dataset(str(tmp_path_factory.mktemp("dp_cli")), n_frames=6, size=64)


def train_two_ranks(data, tmp_path, tag, *extra):
    """Both ranks' records; raises if a rank fails or passes the deadline."""
    store = tmp_path / f"store_{tag}"
    env = dict({k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"},
               OMP_NUM_THREADS=str(TORCH_THREADS), PYTHONPATH=REPO)
    procs, outs = [], []
    for i in range(2):
        outs.append(tmp_path / f"{tag}_rank{i}.json")
        argv = train_argv(data, str(tmp_path), "--device", "cpu", "--num_workers", "0",
                          "--distributed", "--coordinator_address", f"file://{store}",
                          "--num_processes", "2", "--process_id", str(i), *extra)
        procs.append(subprocess.Popen([sys.executable, "-c", CHILD, str(outs[-1])] + argv,
                                      cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs, end = [], time.monotonic() + DEADLINE
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, end - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i}:\n{logs[i][-3000:] if i < len(logs) else ''}"
    records = []
    for out in outs:
        with open(out) as f:
            records.append(json.load(f))
    return records


def test_two_ranks_train_save_once_and_resume(data, tmp_path):
    first = train_two_ranks(data, tmp_path, "first")
    ckpt = tmp_path / "smoke"
    assert [r["shard"] for r in first] == [[0, 2], [1, 2]]
    assert first[0]["digests"] == first[1]["digests"]
    # rank 0 alone writes: two epochs, each its 'latest' through a temporary file
    assert len(first[0]["saved"]) == 2 and first[1]["saved"] == []
    assert all(os.path.dirname(f) == str(ckpt) for f in first[0]["saved"])
    assert sorted(os.listdir(ckpt)) == ["config.json", "latest", "loss_log.txt", "web"]
    assert first[0]["step"] == first[1]["step"] == 2 + 2 * 2   # 2 single, 2 x 2 temporal

    resumed = train_two_ranks(data, tmp_path, "resumed", "--continue_train", "--niter", "3")
    assert [r["start_epoch"] for r in resumed] == [3, 3]
    assert resumed[0]["digests"] == resumed[1]["digests"] != first[0]["digests"]
    assert len(resumed[0]["saved"]) == 1 and resumed[1]["saved"] == []
    assert resumed[0]["step"] == first[0]["step"] + 2 * 2
