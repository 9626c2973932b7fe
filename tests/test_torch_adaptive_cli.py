"""The K = 1 serving export and the CLIs with generated main-branch conv
weights (adaptive_conv) and the adaptive discriminator, on the CPU at
tests/test_torch_adaptive_step.py's tiny sizes (a file of their own, so
that they run on another pytest-xdist worker than the JAX steps there):

  * the K = 1 serving export, whose cache carries the generated conv
    weights: frames against the pipeline's, 1e-5;
  * `cli.train --adaptive_conv --netD_subarch adaptive` and `cli.test
    --finetune` in-process on the synthetic face writer, the test CLI
    taking the discriminator's architecture from the run's config.json.
"""
import os

import numpy as np
import pytest
import torch

from fsvid2vid_tpu_torch.cli import test as cli_test
from fsvid2vid_tpu_torch.cli import train as cli_train
from fsvid2vid_tpu_torch.inference import finetune as tft
from fsvid2vid_tpu_torch.inference.pipeline import InferencePipeline
from fsvid2vid_tpu_torch.inference.serve import export_serving, load_serving
from fsvid2vid_tpu_torch.training import checkpoint as ckpt
from tests.test_torch_adaptive_conv import make_generators
from tests.test_torch_adaptive_step import SERVE_ATOL, SIZE
from tests.test_torch_data import few_threads, write_face_dataset  # noqa: F401 (autouse)
from tests.torch_workers import time_limit


@pytest.fixture(autouse=True)
def _time_limit():
    """The CLIs run loader threads in-process: a hang fails its test."""
    with time_limit(600):
        yield


def test_k1_serving_export_carries_the_conv_weights(tmp_path):
    rng = np.random.RandomState(7)
    _, _, tcfg, _, _, g = make_generators(1)     # numpy-drawn, activations of order one
    tcfg = tcfg.replace(batch_size=1, is_train=False)
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    ref_labels, ref_images = mk(1, 1, SIZE, SIZE, 1), np.tanh(mk(1, 1, SIZE, SIZE, 3))
    frames = [mk(1, SIZE, SIZE, 1) for _ in range(3)]
    pipe = InferencePipeline(tcfg, g)
    pipe.reset(ref_labels, ref_images, frames[0])
    assert len(pipe.cache["conv_weights"]) == 2
    want = [pipe.step(lbl)["fake_image"].numpy() for lbl in frames]
    export_serving(tcfg, g, str(tmp_path / "serve"), dtype=torch.float32)
    session = load_serving(str(tmp_path / "serve"), device="cpu")
    session.reset(ref_labels, ref_images, frames[0])
    w, bias = session.cache["conv_weights"][1][2]      # level 1's conv_s
    assert tuple(w.shape) == (1, 8, 16, 1, 1) and tuple(bias.shape) == (1, 8)
    for t, lbl in enumerate(frames):
        np.testing.assert_allclose(session.step(lbl).numpy(), want[t], atol=SERVE_ATOL,
                                   err_msg=f"frame {t}")
    assert np.std(want) > 0.05


FLAGS = ["--dataset_mode", "fewshot_face", "--adaptive_spade", "--warp_ref",
         "--spade_combine", "--ngf", "4", "--ndf", "4", "--fineSize", "32",
         "--loadSize", "32", "--n_downsample_G", "3", "--n_adaptive_layers", "2",
         "--no_vgg_loss", "--adaptive_conv"]


def test_cli_train_and_finetune(tmp_path, monkeypatch):
    """Two epochs of `cli.train --adaptive_conv --netD_subarch adaptive`
    (the second temporal), then `cli.test --finetune` from `latest` without
    --netD_subarch: the adaptive D comes from config.json, restored and
    adapted with G, and 2 frames written."""
    data = write_face_dataset(str(tmp_path / "face"), n_frames=6, size=64)
    ckpts = str(tmp_path / "ckpt")
    run_ = cli_train.main(["--name", "face", "--dataroot", data, "--checkpoints_dir", ckpts,
                           "--batchSize", "2", "--niter", "2", "--niter_decay", "0",
                           "--niter_single", "1", "--no_flow_gt", "--steps_per_epoch", "2",
                           "--num_workers", "2", "--display_freq", "2", "--print_freq", "2",
                           "--device", "cpu", "--netD_subarch", "adaptive"] + FLAGS)
    assert sorted(run_.trainer.epoch_metrics) == [1, 2]
    for metrics in run_.trainer.epoch_metrics.values():
        assert all(np.isfinite(v) for v in metrics.values())
    stored = ckpt.load(run_.cfg)["networks"]["D"]
    assert "discriminator_0.encoder_0.weight" in stored

    real, seen = tft.finetune, {}

    def checked(cfg, models, *args, **kw):
        seen["subarch"] = cfg.netD_subarch
        seen["restored"] = all(torch.equal(v, stored[k])
                               for k, v in models.netD.state_dict().items())
        before = {n: p.detach().clone() for n, p in models.netD.named_parameters()}
        out = real(cfg, models, *args, **kw)
        seen["d_moved"] = all(not torch.equal(p, before[n])
                              for n, p in models.netD.named_parameters())
        return out
    monkeypatch.setattr(tft, "finetune", checked)
    res = cli_test.main(["--name", "face", "--dataroot", data, "--checkpoints_dir", ckpts,
                         "--results_dir", str(tmp_path / "results"), "--device", "cpu",
                         "--how_many", "2", "--finetune",
                         "--seq_path", os.path.join(data, "test_images", "0001/"),
                         "--ref_img_path", os.path.join(data, "test_images", "0002/")]
                        + FLAGS)
    assert seen == {"subarch": "adaptive", "restored": True, "d_moved": True}
    assert len(res.finetune_losses) == 100 and res.nonfinite_frames == []
    images = os.listdir(os.path.join(res.web_dir, "images"))
    assert sum("synthesized" in i for i in images) == 2
