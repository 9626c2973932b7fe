"""The port's train and test CLIs at --n_shot 2 on the CPU, on
tests/test_torch_cli.py's tiny face flags and 6-frame synthetic dataset
(frames 0 and 5 lie 14 or more frames from any start frame, so each
training sample holds two references):

  * `cli.train --n_shot 2` trains the attention's key and query encoders
    (`atn_*`) through the differentiable K > 1 attention, and its
    checkpoint holds them and their Adam moments; `--continue_train`
    restores them bitwise and trains on;
  * `cli.test --finetune --n_shot 2 --ref_img_id 0,1` finetunes on both
    references, then writes finite frames;
  * `cli.test --n_shot 2` with one reference frame exits naming n_shot.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from fsvid2vid_tpu_torch.cli import test as cli_test
from fsvid2vid_tpu_torch.cli import train as cli_train
from fsvid2vid_tpu_torch.training.checkpoint import load
from tests.test_torch_cli import FACE, TINY, data, train_argv  # noqa: F401 (fixture)
from tests.test_torch_data import few_threads  # noqa: F401 (autouse)

K2 = ["--n_shot", "2"]


def atn_names(netG):
    return [n for n, _ in netG.named_parameters() if n.startswith("atn_")]


@pytest.fixture(scope="module")
def k2_run(data, tmp_path_factory):
    """One single-frame epoch of 2 iterations at batch 2 and K = 2."""
    ckpt = str(tmp_path_factory.mktemp("ckpt_k2"))
    argv = train_argv(data, ckpt, "--device", "cpu", "--niter", "1") + K2
    before = {}
    real_setup = cli_train.setup

    def recording(*args, **kw):
        run = real_setup(*args, **kw)
        before.update({n: p.detach().clone()
                       for n, p in run.trainer.models.netG.named_parameters()})
        return run
    cli_train.setup = recording
    try:
        run = cli_train.main(argv)
    finally:
        cli_train.setup = real_setup
    return data, ckpt, argv, run, before


def test_train_at_k2_trains_and_saves_the_attention_encoders(k2_run):
    data, ckpt, argv, run, before = k2_run
    netG = run.trainer.models.netG
    assert run.cfg.n_shot == 2 and sorted(run.trainer.epoch_metrics) == [1]
    assert all(np.isfinite(v) for v in run.trainer.epoch_metrics[1].values())
    names = atn_names(netG)
    assert len(names) >= 12                       # six encoders' conv and norm
    params = dict(netG.named_parameters())
    moved = [n for n in names if not torch.equal(params[n], before[n])]
    assert len(moved) > len(names) // 2, moved
    stored = load(run.cfg)
    for n in names:
        assert torch.equal(stored["networks"]["G"][n], params[n].detach()), n
    # Adam's moments of every attention parameter (the optimizer's state is
    # keyed by the parameter's position in G)
    index = {n: i for i, (n, _) in enumerate(netG.named_parameters())}
    opt = stored["opt_G"]["state"]
    for n in moved:
        assert opt[index[n]]["exp_avg_sq"].abs().sum() > 0, n


def test_continue_train_at_k2_restores_and_trains_on(k2_run, tmp_path):
    data, ckpt, argv, run, _ = k2_run
    copy = str(tmp_path / "ckpt")
    shutil.copytree(ckpt, copy)
    argv = [copy if a == ckpt else a for a in argv]
    resumed = cli_train.setup(cli_train.build_arg_parser().parse_args(
        argv + ["--continue_train", "--niter", "2"]))
    assert resumed.trainer.start_epoch == 2
    saved = dict(run.trainer.models.netG.named_parameters())
    got = dict(resumed.trainer.models.netG.named_parameters())
    names = atn_names(resumed.trainer.models.netG)
    for n in names:
        assert torch.equal(got[n], saved[n]), n
    want_opt = run.trainer.state.opt_G.state_dict()["state"]
    got_opt = resumed.trainer.state.opt_G.state_dict()["state"]
    assert set(got_opt) == set(want_opt)
    for i in want_opt:
        assert torch.equal(got_opt[i]["exp_avg_sq"], want_opt[i]["exp_avg_sq"]), i
    resumed.trainer.fit(resumed.make_data_iter, resumed.teacher)
    assert sorted(resumed.trainer.epoch_metrics) == [2]
    assert any(not torch.equal(got[n], saved[n]) for n in names)
    assert load(resumed.cfg)["cursor"] == {"epoch": 3, "epoch_iter": 0}


def test_finetune_at_k2_then_frames(k2_run, tmp_path):
    data, ckpt, _, run, _ = k2_run
    res = cli_test.main([
        "--name", "smoke", "--dataroot", data, "--checkpoints_dir", ckpt,
        "--results_dir", str(tmp_path / "results"), "--device", "cpu", "--how_many", "2",
        "--seq_path", os.path.join(data, "test_images", "0001/"),
        "--ref_img_path", os.path.join(data, "test_images", "0002/"),
        "--finetune", "--ref_img_id", "0,1"] + K2 + FACE + TINY)
    assert len(res.finetune_losses) == 100
    assert all(np.isfinite(v) for losses in res.finetune_losses for v in losses.values())
    assert res.finetune_losses[-1]["D_real"] > 0 and res.nonfinite_frames == []
    images = os.listdir(os.path.join(res.web_dir, "images"))
    assert sum("synthesized" in i for i in images) == 2


def test_fewer_reference_ids_than_n_shot_exit_naming_it(data, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli_test.main(["--name", "smoke", "--dataroot", data, "--device", "cpu",
                       "--checkpoints_dir", str(tmp_path), "--n_shot", "3",
                       "--ref_img_id", "0,1"] + FACE + TINY)
    assert e.value.code != 0
    assert "--n_shot 3 needs as many reference frames" in capsys.readouterr().err
