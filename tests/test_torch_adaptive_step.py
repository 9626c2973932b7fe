"""The port's training with generated main-branch conv weights
(adaptive_conv) and the adaptive discriminator (netD_subarch 'adaptive')
against the JAX package's, on the CPU in f32 at tiny sizes (ngf 4, ndf 4,
32 px, three downsamplings, two adaptive layers, batch 2):

  * step 1 of `train_step` and `train_step_faithful` for face at K = 1
    (VGG loss on, the adaptive D at num_D 2 with adaptive_D_layers 2), of
    `train_step` for face at K = 2 (the chunked attention in train mode)
    and of `train_step_faithful` for pose at K = 1 with the face
    discriminator (which stays n_layers, as the temporal one): every key of
    the losses dict, 1e-5 relative (f32 sums in another order through G,
    the discriminators and VGG19; measured: 2.2e-6 at most); gradients before Adam per tensor in the 2-norm, read on the
    JAX side from Adam's first moment (beta1 = 0), plus a floor of 1e-6 of
    the largest tensor norm: the discriminators 1e-3 relative (measured:
    2.2e-5 at most), the generator at K = 2 1e-3 (measured: 3.5e-5).  At
    K = 1 the generator's gradient in these draws is ill-conditioned where
    the generated conv weights enter: in the port alone, a perturbation of
    the reference images by 1e-6 moves it by up to 1.6e-3 per tensor, so the
    two frameworks' f32 rounding moves it by up to 8.6e-2 per tensor and
    1.7e-2 over all of G (measured, the faithful face and the pose steps);
    without adaptive_conv the same draw agrees to 5.6e-5.  There G is held
    to 1e-1 per tensor and 3e-2 over the whole of its gradient;
  * two face finetune steps against the JAX `finetune` loop: losses 1e-5
    relative, the masked generator parameters (the fc_conv stacks among
    them) within 4 lr of JAX's, the others bitwise unchanged, the adaptive
    D's encoder and fc moved;
  * a mid-epoch resume bitwise equal to the run without the interruption;
  * the K = 1 serving export and the CLIs, in
    tests/test_torch_adaptive_cli.py (a file of their own, so that they run
    on another pytest-xdist worker than the JAX steps here).

The discriminators' logits are spread past the hinge's kinks
(tests/test_torch_street_step.py `redrawn_state`).  Each JAX program is
compiled once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu import config as jconfig
from fsvid2vid_tpu.inference import finetune as jft
from fsvid2vid_tpu.models.vgg import Vgg19Features
from fsvid2vid_tpu.training import state as jstate
from fsvid2vid_tpu.training import step as jstep
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.inference import finetune as tft
from fsvid2vid_tpu_torch.training import checkpoint as ckpt
from fsvid2vid_tpu_torch.training import state as tstate
from fsvid2vid_tpu_torch.training import step as tstep
from fsvid2vid_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax, state_dict_from_jax, vgg_state_dict_from_jax)
from tests.test_torch_checkpoint import assert_equal_state, run, tiny_cfg
from tests.test_torch_data import few_threads  # noqa: F401 (autouse)
from tests.test_torch_layers import to_numpy
from tests.test_torch_pose_losses import pose_label
from tests.test_torch_street_step import redrawn_state
from tests.test_torch_train_step import adam_mu, tbatch

LOSS_RTOL = 1e-5
GRAD_RTOL_D = 1e-3
GRAD_RTOL_G = {1: (1e-1, 3e-2), 2: (1e-3, 1e-3)}   # K: (per tensor, all of G)
GRAD_FLOOR = 1e-6
LR = 1e-6
SERVE_ATOL = 1e-5
B, SIZE = 2, 32
OPTS = dict(adaptive_conv=True, netD_subarch="adaptive")
TINY = dict(ngf=4, nff=4, ndf=4, fine_size=SIZE, load_size=SIZE, n_blocks_F=2,
            n_downsample_G=3, n_adaptive_layers=2, **OPTS)
CASES = {"face_k1": ("face", 1, dict(num_D=2, adaptive_D_layers=2)),
         "face_k2": ("face", 2, dict(no_vgg_loss=True)),
         "pose_k1": ("pose", 1, dict(no_vgg_loss=True))}


@dataclasses.dataclass
class Shared:
    jcfg: object
    tcfg: object
    jmodels: object
    jstate0: object
    batch: dict


def labels(cfg, rng, b, *lead, shift=0):
    if cfg.is_pose:
        lbl = pose_label(rng, b * int(np.prod(lead or (1,))), cfg.height, cfg.width,
                         shift=shift)
        return lbl.reshape(b, *lead, cfg.height, cfg.width, 6)
    return rng.randn(b, *lead, cfg.height, cfg.width, cfg.gen_input_nc).astype(np.float32)


def make_shared(case):
    preset, k, kw = CASES[case]
    kw = dict(TINY, n_shot=k, batch_size=B, **kw)
    jcfg = getattr(jconfig, f"{preset}_config")(**kw, compute_dtype="float32")
    tcfg = tconfig.Config.from_json(jcfg.to_json())
    rng = np.random.RandomState(9 + k)
    h, w = jcfg.height, jcfg.width
    img = lambda *s: np.tanh(rng.randn(*s)).astype(np.float32)
    conf = lambda: (rng.rand(B, h, w, 1) > 0.3).astype(np.float32)
    batch = dict(tgt_label=labels(jcfg, rng, B), tgt_image=img(B, h, w, 3),
                 ref_labels=labels(jcfg, rng, B, k, shift=2), ref_images=img(B, k, h, w, 3),
                 flow_gt=[2 * rng.randn(B, h, w, 2).astype(np.float32) for _ in range(2)],
                 conf_gt=[conf(), conf()])
    jmodels = jstate.build_models(jcfg)
    # VGG19's variables are drawn (and then dropped) without the VGG loss too,
    # so that every case draws the same way
    st = redrawn_state(jcfg, dataclasses.replace(jmodels, vgg=Vgg19Features()),
                       jax.tree_util.tree_map(jnp.asarray, batch), rng)
    if jmodels.vgg is None:
        st = st.replace(vgg_params=None)
    return Shared(jcfg, tcfg, jmodels, st, batch)


_SHARED = {}


def shared_for(case):
    if case not in _SHARED:
        _SHARED[case] = make_shared(case)
    return _SHARED[case]


def port_models(tcfg, st):
    models = tstate.build_models(tcfg, device="cpu")
    models.netG.load_state_dict(state_dict_from_jax(
        to_numpy(dict(st.aux_G["G"], params=st.params_G["G"])), tcfg), strict=True)
    for key in st.params_D:
        getattr(models, "net" + key).load_state_dict(discriminator_state_dict_from_jax(
            to_numpy(dict(st.aux_D[key], params=st.params_D[key]))), strict=True)
    if models.vgg is not None:
        models.vgg.load_state_dict(vgg_state_dict_from_jax(to_numpy(st.vgg_params)),
                                   strict=True)
    return models


def assert_grads(shared, state, jst):
    """Step-1 gradients of every network against the JAX step's Adam first
    moment; returns the number of tensors with a real gradient."""
    st0, tcfg = shared.jstate0, shared.tcfg
    want = {"netG": state_dict_from_jax(to_numpy(dict(
        st0.aux_G["G"], params=adam_mu(jst.opt_G)["G"])), tcfg)}
    rtol = {"netG": GRAD_RTOL_G[tcfg.n_shot]}
    for key, mu in adam_mu(jst.opt_D).items():
        want["net" + key] = discriminator_state_dict_from_jax(to_numpy(dict(
            st0.aux_D[key], params=mu)))
        rtol["net" + key] = (GRAD_RTOL_D, GRAD_RTOL_D)
    checked = 0
    for net in want:
        grads = {n: p.grad for n, p in getattr(state.models, net).named_parameters()
                 if p.grad is not None}
        norms = {n: float(np.linalg.norm(want[net][n].numpy())) for n in grads}
        floor = GRAD_FLOOR * max(norms.values(), default=0.0)
        per_tensor, whole = rtol[net]
        diffs = {}
        for name, g in grads.items():
            diffs[name] = float(np.linalg.norm(g.numpy() - want[net][name].numpy()))
            assert diffs[name] <= per_tensor * norms[name] + floor, (
                net, name, diffs[name], norms[name])
            checked += norms[name] > 100 * floor
        total = np.sqrt(sum(d * d for d in diffs.values()))
        assert total <= whole * np.sqrt(sum(n * n for n in norms.values())), (net, total)
    return checked


STEPS = [("face_k1", "train_step"), ("face_k1", "train_step_faithful"),
         ("face_k2", "train_step"), ("pose_k1", "train_step_faithful")]


@pytest.mark.parametrize("case,name", STEPS, ids=[f"{c}-{n}" for c, n in STEPS])
def test_step_one_matches_jax(case, name):
    shared = shared_for(case)
    jbatch = jax.tree_util.tree_map(jnp.asarray, shared.batch)
    jst, _, want, _ = getattr(jstep, name)(
        shared.jcfg, shared.jmodels, shared.jstate0, jbatch,
        jstep.init_prevs(shared.jcfg, jbatch), jstep.StepFlags(), jax.random.PRNGKey(1))
    want = jax.device_get(want)
    state = tstate.TrainState(shared.tcfg, port_models(shared.tcfg, shared.jstate0))
    batch = tbatch(shared.batch)
    _, got, _ = getattr(tstep, name)(shared.tcfg, state, batch,
                                     tstep.init_prevs(shared.tcfg, batch), tstep.StepFlags())
    assert set(got) == set(want)
    for key in sorted(want):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=key)
    for key in ("G_GAN", "G_GAN_Feat", "D_real", "D_fake") + (
            ("Gf_GAN", "Df_real") if shared.tcfg.add_face_D else ()):
        assert float(got[key]) > 0, key
    assert assert_grads(shared, state, jst) > 50
    d = state.models.netD.discriminator_0
    assert d.encoder_0.weight.grad.abs().max() > 0 and d.fc_0.weight.grad.abs().max() > 0
    assert state.models.netG.fc_conv_0_0[0].weight_orig.grad.abs().max() > 0


def test_two_finetune_steps_match_jax(monkeypatch):
    rng = np.random.RandomState(3)
    kw = dict(TINY, batch_size=1, is_train=False, finetune=True, finetune_iters=2, lr=LR)
    jcfg = jconfig.face_config(**kw, compute_dtype="float32")
    tcfg = tconfig.face_config(**kw, compute_dtype="float32")
    assert not tcfg.concat_ref_for_D
    h, w = jcfg.height, jcfg.width
    ref_labels = rng.randn(1, 1, h, w, 1).astype(np.float32)
    ref_images = np.tanh(rng.randn(1, 1, h, w, 3)).astype(np.float32)
    jmodels = jstate.build_models(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in dict(
        tgt_label=ref_labels[:, 0], tgt_image=ref_images[:, 0],
        ref_labels=ref_labels, ref_images=ref_images).items()}
    st = redrawn_state(jcfg, jmodels, jbatch, rng)

    recorded = []
    step = jft._finetune_step

    def recording(*args):
        out = step(*args)
        recorded.append(jax.device_get(out[2]))
        return out
    monkeypatch.setattr(jft, "_finetune_step", recording)
    jst = jft.finetune(jcfg, jmodels, st, jnp.asarray(ref_labels), jnp.asarray(ref_images),
                       seed=4)

    models = port_models(tcfg, st)
    before = {n: p.detach().clone() for n, p in models.netG.named_parameters()}
    before_D = {n: p.detach().clone() for n, p in models.netD.named_parameters()}
    state, history = tft.finetune(tcfg, models, ref_labels, ref_images, seed=4)
    assert state.step == len(history) == len(recorded) == 2
    for it, (got, want) in enumerate(zip(history, recorded)):
        assert set(got) == set(want) | {"G_total", "D_total"}
        for key in sorted(want):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=LOSS_RTOL,
                                       atol=1e-6, err_msg=f"step {it} {key}")
    mask = tft.finetune_mask(models.netG)
    assert all(mask[n] for n in before if n.startswith("fc_conv_"))
    want_G = state_dict_from_jax(to_numpy(dict(jst.aux_G["G"], params=jst.params_G["G"])),
                                 tcfg)
    moved = 0
    for name, p in models.netG.named_parameters():
        if mask[name]:
            moved += int(not torch.equal(p, before[name]))
            np.testing.assert_allclose(p.detach().numpy(), want_G[name].numpy(),
                                       atol=4 * LR, rtol=0, err_msg=name)
        else:
            assert torch.equal(p, before[name]), name
    assert moved > 0.5 * sum(mask.values())
    assert any(not torch.equal(p, before[n]) for n, p in models.netG.named_parameters()
               if n.startswith("fc_conv_"))
    for n, p in models.netD.named_parameters():
        if ".encoder_" in n or ".fc_" in n:
            assert not torch.equal(p, before_D[n]), n


def test_resume_mid_epoch_is_bitwise_equal(tmp_path):
    """tests/test_torch_checkpoint.py's mid-epoch resume in the temporal
    phase with both features: the fc_conv stacks and the adaptive D's
    encoder, fc and spectral state come back with their Adam moments."""
    kw = dict(niter=2, niter_decay=0, niter_single=1, save_latest_freq=2 * B,
              no_vgg_loss=True, **OPTS)
    whole = run(tiny_cfg(tmp_path / "a", **kw))
    run(tiny_cfg(tmp_path / "b", **kw), stop_at=(2, 2))
    stored = ckpt.load(tiny_cfg(tmp_path / "b", **kw))
    assert stored["cursor"] == {"epoch": 2, "epoch_iter": 2}
    assert any(k.startswith("fc_conv_") for k in stored["networks"]["G"])
    assert "discriminator_0.fc_0.weight" in stored["networks"]["D"]
    resumed = run(tiny_cfg(tmp_path / "b", continue_train=True, **kw))
    assert resumed.state.step == whole.state.step == 3 + 6
    assert_equal_state(resumed.state, whole.state)
