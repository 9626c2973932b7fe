"""The port's checkpoints (fsvid2vid_tpu_torch/training/checkpoint.py) on the
CPU in f32, at a tiny size: what a save holds and a restore gives back,
resume in a fresh trainer bitwise equal to a run without the interruption,
restores of subsets, and writes that never leave a truncated file; a pose
run with the face discriminator resumes bitwise too, Df's weights and its
share of the D Adam state included."""
import os

import numpy as np
import pytest
import torch

from fsvid2vid_tpu_torch.config import face_config, pose_config
from fsvid2vid_tpu_torch.training import checkpoint as ckpt
from fsvid2vid_tpu_torch.training import state as tstate
from fsvid2vid_tpu_torch.training import step as tstep
from fsvid2vid_tpu_torch.training.trainer import Trainer
from tests.test_torch_data import few_threads  # noqa: F401 (autouse)
from tests.test_torch_pose_losses import pose_label

B, SIZE = 2, 32


def tiny_cfg(tmp_path, **kw):
    kw = {"name": "run", **kw}
    return face_config(ngf=4, nff=4, ndf=4, fine_size=SIZE, load_size=SIZE, n_blocks_F=2,
                       n_downsample_G=3, n_adaptive_layers=2, batch_size=B,
                       compute_dtype="float32", checkpoints_dir=str(tmp_path),
                       no_flow_gt=True, print_freq=0, display_freq=0, **kw)


def sequence(seed, t=1):
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    return dict(tgt_label=mk(B, t, SIZE, SIZE, 1), tgt_image=np.tanh(mk(B, t, SIZE, SIZE, 3)),
                ref_labels=mk(B, 1, SIZE, SIZE, 1), ref_images=np.tanh(mk(B, 1, SIZE, SIZE, 3)))


def new_state(cfg, seed):
    models = tstate.build_models(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    return tstate.TrainState(cfg, models)


def step(cfg, state, seed):
    seq = {k: torch.from_numpy(v[:, 0] if k.startswith("tgt") else v)
           for k, v in sequence(seed).items()}
    tstep.train_step(cfg, state, seq, tstep.init_prevs(cfg, seq), tstep.StepFlags(), "float32")


def everything(state):
    """Every tensor a checkpoint must carry, by name."""
    out = {}
    for key, attr in ckpt.NETWORKS.items():
        net = getattr(state.models, attr)
        for name, t in (net.state_dict() if net is not None else {}).items():
            out[f"{key}.{name}"] = t
    for name in ("opt_G", "opt_D"):
        for i, moments in getattr(state, name).state_dict()["state"].items():
            for m, t in moments.items():
                out[f"{name}.{i}.{m}"] = t
    return out


def assert_equal_state(a, b):
    ea, eb = everything(a), everything(b)
    assert ea.keys() == eb.keys()
    for k in ea:
        assert torch.equal(ea[k], eb[k]), k
    assert a.step == b.step


def test_round_trip(tmp_path):
    """Parameters, Adam moments, spectral u / v, batch-norm statistics, the
    VGG19 weights, the step and the cursor come back exactly, into the same
    module and optimizer objects."""
    cfg = tiny_cfg(tmp_path)
    saved = new_state(cfg, 1)
    step(cfg, saved, 2)
    path = ckpt.save(cfg, saved, epoch=3, epoch_iter=5)
    assert path == os.path.join(str(tmp_path), "run", "latest")
    assert os.path.exists(os.path.join(str(tmp_path), "run", "config.json"))

    state = new_state(cfg, 9)
    held = [p for g in state.opt_G.param_groups for p in g["params"]]
    names = everything(saved)
    assert any(k.endswith("weight_u") for k in names)
    assert any(k.endswith("running_var") for k in names)
    assert any(k.endswith("exp_avg_sq") for k in names)
    assert any(k.startswith("vgg.") for k in names)
    assert not all(torch.equal(everything(state)[k], v) for k, v in names.items())
    restored, epoch, it = ckpt.restore(cfg, state)
    assert (restored, epoch, it) == (True, 3, 5)
    assert_equal_state(state, saved)
    assert all(a is b for a, b in zip(held, state.models.netG.parameters()))
    assert state.opt_G.state and {id(p) for p in state.opt_G.state} <= {id(p) for p in held}
    assert ckpt.restore(cfg.replace(name="none"), state) == (False, 1, 0)


def test_save_epoch_cursor_and_snapshots(tmp_path):
    cfg = tiny_cfg(tmp_path, save_epoch_freq=2)
    state = new_state(cfg, 1)
    for epoch in (1, 2):
        ckpt.save_epoch(cfg, state, epoch)
    files = sorted(os.listdir(os.path.join(str(tmp_path), "run")))
    assert files == ["config.json", "epoch_2", "latest"]
    assert ckpt.load(cfg)["cursor"] == {"epoch": 3, "epoch_iter": 0}


def test_a_failed_write_keeps_the_previous_checkpoint(tmp_path, monkeypatch):
    cfg = tiny_cfg(tmp_path)
    state = new_state(cfg, 1)
    ckpt.save(cfg, state, epoch=1, epoch_iter=1)

    def torn(obj, f):   # a crash halfway through the write
        with open(f, "wb") as out:
            out.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn)
    with pytest.raises(OSError):
        ckpt.save(cfg, state, epoch=2, epoch_iter=2)
    assert sorted(os.listdir(os.path.join(str(tmp_path), "run"))) == ["config.json", "latest"]
    assert ckpt.load(cfg)["cursor"] == {"epoch": 1, "epoch_iter": 1}


class Interrupted(Exception):
    pass


def run(cfg, stop_at=None, make_sequence=sequence):
    """fit() over 3 sequences an epoch (epoch 2 is temporal, 2 frames);
    with stop_at=(epoch, idx) the data stops with an exception there."""
    def data(epoch, n_frames_total):
        for idx in range(3):
            if (epoch, idx) == stop_at:
                raise Interrupted
            yield make_sequence(100 * epoch + idx, n_frames_total)
    trainer = Trainer(cfg, log_fn=lambda m: None, device="cpu")
    trainer.setup()
    try:
        trainer.fit(data)
    except Interrupted:
        pass
    return trainer


def test_resume_mid_epoch_is_bitwise_equal(tmp_path):
    """A run saved at iteration 2 of the first temporal epoch, interrupted
    and continued by a fresh trainer (continue_train), ends bitwise equal to
    the same run without the interruption.  The temporal copy of the
    previous-frame embedding happens once, before the save; the resumed
    trainer does not repeat it."""
    kw = dict(niter=2, niter_decay=0, niter_single=1, save_latest_freq=2 * B,
              no_vgg_loss=True)
    whole = run(tiny_cfg(tmp_path / "a", **kw))
    run(tiny_cfg(tmp_path / "b", **kw), stop_at=(2, 2))
    assert ckpt.load(tiny_cfg(tmp_path / "b", **kw))["cursor"] == {"epoch": 2,
                                                                   "epoch_iter": 2}
    resumed = run(tiny_cfg(tmp_path / "b", continue_train=True, **kw))
    assert resumed.start_epoch == 2 and resumed.state.step == whole.state.step == 3 + 6
    assert_equal_state(resumed.state, whole.state)
    # without continue_train a run starts afresh
    fresh = Trainer(tiny_cfg(tmp_path / "b", **kw), log_fn=lambda m: None, device="cpu")
    fresh.setup()
    assert fresh.start_epoch == 1 and fresh.state.step == 0


def pose_cfg(tmp_path, **kw):
    return pose_config(name="run", ngf=4, nff=4, ndf=4, fine_size=SIZE, load_size=SIZE,
                       n_blocks_F=2, n_downsample_G=3, n_adaptive_layers=2, batch_size=B,
                       compute_dtype="float32", checkpoints_dir=str(tmp_path),
                       no_flow_gt=True, print_freq=0, display_freq=0, **kw)


def pose_sequence(seed, t=1):
    """Pose labels (B, t, 2 SIZE, SIZE, 6) with body and face parts."""
    rng = np.random.RandomState(seed)
    h, w = 2 * SIZE, SIZE
    img = lambda *s: np.tanh(rng.randn(*s)).astype(np.float32)
    return dict(tgt_label=np.stack([pose_label(rng, B, h, w, shift=i) for i in range(t)], 1),
                tgt_image=img(B, t, h, w, 3),
                ref_labels=pose_label(rng, B, h, w, shift=2)[:, None],
                ref_images=img(B, 1, h, w, 3))


def test_pose_run_with_face_d_resumes_bitwise(tmp_path):
    """The mid-epoch resume of test_resume_mid_epoch_is_bitwise_equal on a
    pose configuration with the face discriminator and remat: Df's weights,
    spectral u / v and Adam moments are saved and come back."""
    kw = dict(niter=2, niter_decay=0, niter_single=1, save_latest_freq=2 * B,
              no_vgg_loss=True)
    whole = run(pose_cfg(tmp_path / "a", **kw), make_sequence=pose_sequence)
    run(pose_cfg(tmp_path / "b", **kw), stop_at=(2, 2), make_sequence=pose_sequence)
    stored = ckpt.load(pose_cfg(tmp_path / "b", **kw))
    assert stored["cursor"] == {"epoch": 2, "epoch_iter": 2}
    assert "Df" in stored["networks"]
    resumed = run(pose_cfg(tmp_path / "b", continue_train=True, **kw),
                  make_sequence=pose_sequence)
    assert resumed.cfg.remat and resumed.cfg.add_face_D
    assert resumed.state.step == whole.state.step == 3 + 6
    names = everything(resumed.state)
    assert any(k.startswith("Df.") and k.endswith("weight_u") for k in names)
    df = {id(p) for p in resumed.models.netDf.parameters()}
    moments = [m for p, m in resumed.state.opt_D.state.items() if id(p) in df]
    assert len(moments) == len(df) and all("exp_avg_sq" in m for m in moments)
    assert_equal_state(resumed.state, whole.state)


def test_inference_restore_drops_the_discriminators(tmp_path):
    cfg = tiny_cfg(tmp_path)
    saved = new_state(cfg, 1)
    step(cfg, saved, 2)
    ckpt.save(cfg, saved, epoch=1)
    models = tstate.build_models(cfg.replace(is_train=False), device="cpu")
    assert models.netD is None and models.vgg is None
    ckpt.restore_models(models, ckpt.load(cfg))
    for k, v in saved.models.netG.state_dict().items():
        assert torch.equal(models.netG.state_dict()[k], v), k


def test_entries_of_another_shape_keep_their_values(tmp_path):
    """A checkpoint of a wider discriminator: G and its optimizer come back,
    D's tensors and optimizer keep the template's (base_model.py:84-85)."""
    cfg = tiny_cfg(tmp_path)
    saved = new_state(cfg.replace(ndf=8), 1)
    step(cfg.replace(ndf=8), saved, 2)
    ckpt.save(cfg, saved, epoch=1)
    state = new_state(cfg, 3)
    step(cfg, state, 4)
    d_before = {k: v.clone() for k, v in state.models.netD.state_dict().items()}
    opt_d_before = state.opt_D.state_dict()
    assert ckpt.restore(cfg, state)[0]
    for k, v in saved.models.netG.state_dict().items():
        assert torch.equal(state.models.netG.state_dict()[k], v), k
    got_d = state.models.netD.state_dict()
    stored_d = saved.models.netD.state_dict()
    for k, v in d_before.items():
        want = stored_d[k] if stored_d[k].shape == v.shape else v
        assert torch.equal(got_d[k], want), k
    assert any(stored_d[k].shape != v.shape for k, v in d_before.items())
    assert all(torch.equal(a["exp_avg"], b["exp_avg"]) for a, b in zip(
        state.opt_D.state_dict()["state"].values(), opt_d_before["state"].values()))
    g_saved = saved.opt_G.state_dict()["state"]
    assert all(torch.equal(a["exp_avg_sq"], g_saved[i]["exp_avg_sq"])
               for i, a in state.opt_G.state_dict()["state"].items())


def test_load_pretrain_warm_starts_the_networks_only(tmp_path):
    """--load_pretrain: G, D and the temporal D from another run's latest;
    the optimizers, VGG19, the step and the schedule start fresh."""
    pre = tiny_cfg(tmp_path, name="pretrained")
    saved = new_state(pre, 1)
    step(pre, saved, 2)
    ckpt.save(pre, saved, epoch=4, epoch_iter=1)
    cfg = tiny_cfg(tmp_path, load_pretrain=os.path.join(str(tmp_path), "pretrained"))
    trainer = Trainer(cfg, log_fn=lambda m: None, device="cpu")
    vgg_before = {k: v.clone() for k, v in trainer.models.vgg.state_dict().items()}
    trainer.setup()
    for attr in ("netG", "netD", "netDT"):
        for k, v in getattr(saved.models, attr).state_dict().items():
            assert torch.equal(getattr(trainer.models, attr).state_dict()[k], v), (attr, k)
    for k, v in trainer.models.vgg.state_dict().items():
        assert torch.equal(v, vgg_before[k]), k
    assert not trainer.state.opt_G.state and trainer.state.step == 0
    assert (trainer.start_epoch, trainer.epoch_iter) == (1, 0)
