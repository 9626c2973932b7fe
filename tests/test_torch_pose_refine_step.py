"""Pose training with face refinement (refine_face: the face generator
netGf on the face crops of every generated frame) against the JAX
package's, on the CPU in f32, and through the port's entry points:

  * step 1 of `train_step` (temporal, numpy-drawn previous frames) at
    128 x 64 (fine_size 64 at the pose aspect ratio 0.5: 32 x 32 face
    crops), ngf 4, ndf 4, three downsamplings, batch 2, remove_face_labels,
    the face D and remat on, with the flows and confidences of the port's
    pose teacher (random FlowNet2 weights, on the labels' DensePose
    channels) fed to both: every loss, Gf_GAN and Gf_GAN_Feat included,
    1e-5 relative (1e-6 absolute for losses near 0); then netGf's gradient
    link by link, because a gradient of the whole step is not continuous
    at this point: netGf's inputs equal JAX's (the label and reference
    crops 1e-6, the coarse face, G's train-mode frame, 2e-4); the
    cotangent at netGf's output 1e-4 of its largest element off the kink of
    replace_face_region's clamp to [-1, 1] (a pixel whose refined value
    lies within the forward's rounding of +-1 takes the gradient in one
    framework and not in the other: one such pixel of 6,144 here moves
    every netGf gradient by ~1 %, and the coarse face's 1.3e-4 moves the
    coarse encoder's by up to 0.9 %); every netGf gradient of the port's
    backward from JAX's inputs and cotangent against JAX's, 1e-4 of its
    2-norm plus a floor of 1e-6 of the largest; the JAX step's netGf
    gradient (Adam's first moment, beta1 = 0) is JAX's backward, and the
    port step's the port's, to the same bound.  VGG is off here, as its discontinuity
    blurs gradients by 1e-2 (tests/test_torch_train_step.py's docstring);
  * two finetune steps at 64 x 32 with netGf inside the mask, against JAX
    `finetune`: losses 1e-4 relative, netGf's masked parameters within 4 lr
    of JAX's and the others bitwise unchanged (tests/test_torch_finetune.py's
    rule);
  * a checkpoint with netGf: a mid-epoch resume inside the temporal phase
    ends bitwise equal to the same run without the interruption
    (tests/test_torch_checkpoint.py's run), netGf's state and its share of
    G's Adam state included;
  * `cli.train --dataset_mode fewshot_pose --refine_face` and `cli.test
    --refine_face --finetune` in-process on the synthetic pose writer's
    dataset.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.config import pose_config as jpose
from fsvid2vid_tpu.inference import finetune as jft
from fsvid2vid_tpu.training import state as jstate
from fsvid2vid_tpu.training import step as jstep
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.cli import test as cli_test
from fsvid2vid_tpu_torch.cli import train as cli_train
from fsvid2vid_tpu_torch.inference import finetune as tft
from fsvid2vid_tpu_torch.models.face_refiner import face_refiner_config
from fsvid2vid_tpu_torch.training import checkpoint as ckpt
from fsvid2vid_tpu_torch.training import state as tstate
from fsvid2vid_tpu_torch.training import step as tstep
from fsvid2vid_tpu_torch.training.flow_teacher import FlowTeacher
from fsvid2vid_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax, state_dict_from_jax, vgg_state_dict_from_jax)
from tests.test_torch_checkpoint import assert_equal_state, pose_cfg, pose_sequence, run
from tests.test_torch_data import few_threads  # noqa: F401 (autouse)
from tests.test_torch_layers import randomize, to_numpy
from tests.test_torch_pose_losses import pose_label
from tests.test_torch_train_layers import random_uv
from tests.test_torch_train_step import adam_mu, tbatch

LOSS_RTOL = 1e-5
FT_LOSS_RTOL = 1e-4
COARSE_ATOL = 2e-4     # G's train-mode frame, cropped
COT_ATOL = 1e-4        # of the cotangent's largest element
KINK = 1e-4            # refined values this close to +-1 sit on the clamp's kink
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-6
LR = 1e-6
B = 2


def tiny(**kw):
    return dict(ngf=4, nff=4, ndf=4, n_blocks_F=2, n_downsample_G=3, n_adaptive_layers=2,
                refine_face=True, **kw)


def redrawn_state(jcfg, jmodels, jbatch, rng):
    """A JAX train state shaped by its init on `jbatch`, every variable of
    G, Gf, the discriminators and VGG19 redrawn from numpy; the
    discriminators' logits spread past the hinge's kinks
    (tests/test_torch_train_step.py)."""
    st = jax.eval_shape(lambda: jstate.init_state(jcfg, jmodels, jax.random.PRNGKey(0),
                                                  jbatch))

    def redraw(params, aux):
        v = randomize(dict(aux, params=params), rng)
        v = random_uv(v, rng) if "spectral" in v else v
        return v.pop("params"), v

    params_G, aux_G = {}, {}
    for k in st.params_G:
        params_G[k], aux_G[k] = redraw(st.params_G[k], st.aux_G[k])
    params_D, aux_D = {}, {}
    for k in st.params_D:
        params_D[k], aux_D[k] = redraw(st.params_D[k], st.aux_D[k])
        logit_conv = params_D[k]["discriminator_0"][f"model{jcfg.n_layers_D + 1}_conv"]
        logit_conv["kernel"] = logit_conv["kernel"] * 4
        logit_conv["bias"] = logit_conv["bias"] + 1.0
    vgg = None
    if st.vgg_params is not None:
        vgg = jax.tree_util.tree_map(lambda a: a * np.float32(np.sqrt(2.0)),
                                     randomize({"params": st.vgg_params}, rng)["params"])
    opt_G, opt_D = jstate.make_optimizers(jcfg)
    return jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params_G=params_G, aux_G=aux_G,
        params_D=params_D, aux_D=aux_D, vgg_params=vgg,
        opt_G=opt_G.init(params_G), opt_D=opt_D.init(params_D))


def port_models(tcfg, st):
    """The port's networks of `tcfg` on the CPU, holding the JAX state."""
    models = tstate.build_models(tcfg, device="cpu")
    gen_cfg = {"G": tcfg, "Gf": face_refiner_config(tcfg)}
    for key, cfg in gen_cfg.items():
        getattr(models, "net" + key).load_state_dict(state_dict_from_jax(
            to_numpy(dict(st.aux_G[key], params=st.params_G[key])), cfg), strict=True)
    for key in st.params_D:
        getattr(models, "net" + key).load_state_dict(discriminator_state_dict_from_jax(
            to_numpy(dict(st.aux_D[key], params=st.params_D[key]))), strict=True)
    if models.vgg is not None:
        models.vgg.load_state_dict(vgg_state_dict_from_jax(to_numpy(st.vgg_params)),
                                   strict=True)
    return models


@dataclasses.dataclass
class Shared:
    jcfg: object
    tcfg: object
    jmodels: object
    jstate0: object
    batch: dict
    prevs: dict


@pytest.fixture(scope="module")
def shared():
    """A temporal step's inputs at 128 x 64: labels and images of two
    frames, the pose teacher's flows of frame 1 to the reference and to
    frame 0, frame 0 as the previous-frames buffers."""
    rng = np.random.RandomState(9)
    jcfg = jpose(**tiny(fine_size=64, load_size=64, batch_size=B, compute_dtype="float32", no_vgg_loss=True))
    tcfg = tconfig.Config.from_json(jcfg.to_json())
    h, w = jcfg.height, jcfg.width
    img = lambda *s: np.tanh(rng.randn(*s)).astype(np.float32)
    seq = dict(tgt_label=np.stack([pose_label(rng, B, h, w, shift=t) for t in (0, 1)], 1),
               tgt_image=img(B, 2, h, w, 3), ref_labels=pose_label(rng, B, h, w, shift=3)[:, None],
               ref_images=img(B, 1, h, w, 3))
    teacher = FlowTeacher(tcfg, device="cpu", generator=torch.Generator().manual_seed(2))
    flow, conf = teacher(tcfg, {k: torch.from_numpy(v) for k, v in seq.items()},
                         tcfg.niter_single + 1)
    batch = dict(tgt_label=seq["tgt_label"][:, 1], tgt_image=seq["tgt_image"][:, 1],
                 ref_labels=seq["ref_labels"], ref_images=seq["ref_images"],
                 flow_gt=[f[:, 1].numpy() for f in flow],
                 conf_gt=[c[:, 1].numpy() for c in conf])
    prevs = dict(label=seq["tgt_label"][:, 0], real=seq["tgt_image"][:, 0],
                 fake=img(B, h, w, 3))
    jmodels = jstate.build_models(jcfg)
    assert jmodels.netGf is not None and jmodels.netDf is not None
    st = redrawn_state(jcfg, jmodels, jax.tree_util.tree_map(jnp.asarray, batch), rng)
    return Shared(jcfg, tcfg, jmodels, st, batch, prevs)


@jax.custom_vjp
def _tap(y):
    return y


def _tap_fwd(y):
    return y, None


def _tap_bwd(_, g):
    jax.debug.callback(lambda a: TAPPED.__setitem__("cot", np.array(a)), g)
    return (g,)


_tap.defvjp(_tap_fwd, _tap_bwd)
TAPPED = {}


def _tapped_apply(apply):
    """netGf's apply in the JAX step, recording its inputs and the
    cotangent that reaches its output."""
    def wrapped(*inputs):
        for i, x in enumerate(inputs):
            jax.debug.callback(lambda a, i=i: TAPPED.__setitem__(i, np.array(a)), x)
        return _tap(apply(*inputs))
    return wrapped


def test_step_one_with_refiner_matches_jax(shared, monkeypatch):
    """Losses, then netGf's gradients link by link: its inputs (the crops)
    equal JAX's; the cotangent at its output equals JAX's on every pixel but
    those whose refined value lies at the kink of replace_face_region's
    clamp; its backward from JAX's inputs and cotangent gives every
    parameter what JAX's does; and the step's netGf gradients are that
    backward of the step's own cotangent."""
    flags = (True, True)
    refine = jstep.refine_face_region
    monkeypatch.setattr(jstep, "refine_face_region", lambda cfg, apply, *a: refine(
        cfg, _tapped_apply(apply), *a))
    TAPPED.clear()
    jst, _, want, _ = jstep.train_step(
        shared.jcfg, shared.jmodels, shared.jstate0,
        jax.tree_util.tree_map(jnp.asarray, shared.batch),
        jax.tree_util.tree_map(jnp.asarray, shared.prevs), jstep.StepFlags(*flags),
        jax.random.PRNGKey(1))
    jax.block_until_ready(jst.step)
    models = port_models(shared.tcfg, shared.jstate0)
    gf0 = {n: p.detach().clone() for n, p in models.netGf.named_parameters()}
    forward_face, seen = models.netGf.forward_face, {}

    def recorded(*args):
        seen["args"] = [a.detach().clone() for a in args]
        y = forward_face(*args)
        y.register_hook(lambda g: seen.__setitem__("cot", g.clone()))
        seen["face"] = (y + args[3]).detach()
        return y
    models.netGf.forward_face = recorded
    state = tstate.TrainState(shared.tcfg, models)
    _, got, _ = tstep.train_step(shared.tcfg, state, tbatch(shared.batch),
                                 tbatch(shared.prevs), tstep.StepFlags(*flags))
    want = jax.device_get(want)
    assert set(got) == set(want)
    for key in sorted(want):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=key)
    for key in ("G_GAN", "Gf_GAN", "Gf_GAN_Feat", "F_Flow", "F_Mask", "Df_real", "Df_fake"):
        assert float(got[key]) > 0, key

    # netGf's inputs: the label and reference crops, and the coarse face
    # (G's frame after a train-mode forward)
    nchw = lambda a: torch.from_numpy(a).movedim(-1, -3)
    jax_in = [nchw(TAPPED[i]) for i in range(4)]
    for i, (a, b) in enumerate(zip(seen["args"], jax_in)):
        torch.testing.assert_close(a, b, rtol=0, atol=COARSE_ATOL if i == 3 else 1e-6)
    # the cotangent at netGf's output, off the clamp's kink
    jax_cot = nchw(TAPPED["cot"])
    kink = (seen["face"].abs() - 1).abs() < KINK
    assert kink.float().mean() < 1e-3
    assert ((seen["cot"] - jax_cot).abs()[~kink] <= COT_ATOL * jax_cot.abs().max()).all()

    # netGf's backward
    names = [n for n, _ in models.netGf.named_parameters()]

    def port_backward(inputs, cot):   # from the step's starting state
        fresh = port_models(shared.tcfg, shared.jstate0).netGf.train()
        params = [p for _, p in fresh.named_parameters()]
        grads = torch.autograd.grad(fresh.forward_face(*inputs), params, cot,
                                    allow_unused=True)
        # a tensor the forward never reads (the finest reference decoder
        # level, whose features no adaptive layer takes) has gradient zero
        return {n: torch.zeros_like(p) if g is None else g
                for n, p, g in zip(names, params, grads)}
    gf = shared.jmodels.netGf
    aux = shared.jstate0.aux_G["Gf"]
    _, vjp = jax.vjp(lambda p: gf.apply(
        dict(aux, params=p), *[jnp.asarray(TAPPED[i]) for i in range(4)], train=True,
        method=gf.forward_face, mutable=["spectral", "batch_stats"])[0],
        shared.jstate0.params_G["Gf"])
    jax_grads = state_dict_from_jax(to_numpy(dict(aux, params=vjp(jnp.asarray(TAPPED["cot"]))[0])),
                                    face_refiner_config(shared.tcfg))
    from_jax = port_backward(jax_in, jax_cot)
    floor = GRAD_FLOOR * max(np.linalg.norm(jax_grads[n].numpy()) for n in names)

    def assert_grad_close(got, want, name):
        got, want = np.asarray(got), np.asarray(want)
        assert np.linalg.norm(got - want) <= GRAD_RTOL * np.linalg.norm(want) + floor, name
    for n in names:
        assert_grad_close(from_jax[n].numpy(), jax_grads[n].numpy(), n)
    assert sum(int(not jax_grads[n].any()) for n in names) < 0.2 * len(names)
    # the JAX step's netGf gradient is that backward (Adam's first moment,
    # beta1 = 0), and the port step's is its own backward
    mu = state_dict_from_jax(to_numpy(dict(aux, params=adam_mu(jst.opt_G)["Gf"])),
                             face_refiner_config(shared.tcfg))
    from_port = port_backward(seen["args"], seen["cot"])
    for n, p in models.netGf.named_parameters():
        assert_grad_close(mu[n].numpy(), jax_grads[n].numpy(), "JAX step " + n)
        step_g = torch.zeros_like(p) if p.grad is None else p.grad
        assert_grad_close(step_g.numpy(), from_port[n].numpy(), "port step " + n)
    moved = sum(int(not torch.equal(p, gf0[n])) for n, p in models.netGf.named_parameters())
    assert moved > 0.9 * len(gf0)


def test_two_finetune_steps_with_gf_match_jax(monkeypatch):
    rng = np.random.RandomState(3)
    kw = tiny(fine_size=32, load_size=32, batch_size=1, is_train=False, finetune=True,
              finetune_iters=2, lr=LR, compute_dtype="float32")
    jcfg = jpose(**kw)
    tcfg = tconfig.Config.from_json(jcfg.to_json())
    h, w = jcfg.height, jcfg.width
    ref_labels = pose_label(rng, 1, h, w)[:, None]
    ref_images = np.tanh(rng.randn(1, 1, h, w, 3)).astype(np.float32)
    jmodels = jstate.build_models(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in dict(
        tgt_label=ref_labels[:, 0], tgt_image=ref_images[:, 0],
        ref_labels=ref_labels, ref_images=ref_images).items()}
    st = redrawn_state(jcfg, jmodels, jbatch, rng)
    assert set(st.params_G) == {"G", "Gf"}

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
    before = {n: p.detach().clone() for n, p in models.netGf.named_parameters()}
    state, history = tft.finetune(tcfg, models, ref_labels, ref_images, seed=4)
    assert len(history) == len(recorded) == 2
    assert {id(p) for g in state.opt_G.param_groups for p in g["params"]} >= {
        id(p) for n, p in models.netGf.named_parameters()
        if tft.finetune_mask(models.netGf)[n]}
    for it, (got, want) in enumerate(zip(history, recorded)):
        assert set(got) == set(want) | {"G_total", "D_total"}
        for key in sorted(want):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=FT_LOSS_RTOL,
                                       atol=1e-6, err_msg=f"step {it} {key}")
        assert float(got["Gf_GAN"]) > 0
    mask = tft.finetune_mask(models.netGf)
    want_gf = state_dict_from_jax(to_numpy(dict(jst.aux_G["Gf"], params=jst.params_G["Gf"])),
                                  face_refiner_config(tcfg))
    moved = 0
    for name, p in models.netGf.named_parameters():
        if mask[name]:
            moved += int(not torch.equal(p, before[name]))
            np.testing.assert_allclose(p.detach().numpy(), want_gf[name].numpy(),
                                       atol=4 * LR, rtol=0, err_msg=name)
        else:
            assert torch.equal(p, before[name]), name
            np.testing.assert_array_equal(want_gf[name].numpy(), before[name].numpy())
    assert 0 < sum(mask.values()) < len(mask) and moved > 0.5 * sum(mask.values())


def test_pose_run_with_refiner_resumes_bitwise(tmp_path):
    """tests/test_torch_checkpoint.py's mid-epoch resume in the temporal
    phase with refine_face: netGf's tensors and its Adam moments are saved
    and come back, and the resumed run ends bitwise where the whole one
    does."""
    kw = dict(niter=2, niter_decay=0, niter_single=1, save_latest_freq=2 * B,
              no_vgg_loss=True, refine_face=True)
    whole = run(pose_cfg(tmp_path / "a", **kw), make_sequence=pose_sequence)
    run(pose_cfg(tmp_path / "b", **kw), stop_at=(2, 2), make_sequence=pose_sequence)
    stored = ckpt.load(pose_cfg(tmp_path / "b", **kw))
    assert stored["cursor"] == {"epoch": 2, "epoch_iter": 2}
    assert set(stored["networks"]) >= {"G", "Gf", "Df"}
    n_g = sum(1 for _ in whole.models.netG.parameters())
    n_gf = sum(1 for _ in whole.models.netGf.parameters())
    gf_moments = [i for i in stored["opt_G"]["state"] if n_g <= i < n_g + n_gf]
    assert len(gf_moments) > 0.8 * n_gf     # G's Adam holds netGf's moments
    resumed = run(pose_cfg(tmp_path / "b", continue_train=True, **kw),
                  make_sequence=pose_sequence)
    assert resumed.state.step == whole.state.step == 3 + 6
    assert_equal_state(resumed.state, whole.state)
    gf = dict(whole.models.netGf.state_dict())
    assert all(torch.equal(v, gf[k]) for k, v in resumed.models.netGf.state_dict().items())


POSE = ["--dataset_mode", "fewshot_pose", "--adaptive_spade", "--warp_ref",
        "--spade_combine", "--remove_face_labels", "--add_face_D", "--remat",
        "--refine_face"]
TINY_FLAGS = ["--ngf", "4", "--ndf", "4", "--fineSize", "32", "--loadSize", "32",
              "--n_downsample_G", "3", "--n_adaptive_layers", "2", "--no_vgg_loss"]


def test_cli_train_and_finetune_with_refiner(tmp_path, monkeypatch):
    """Two epochs of `cli.train --refine_face` (the second temporal), then
    `cli.test --refine_face --finetune` from `latest`: netGf restored with G,
    adapted inside its mask, and refining the 2 frames written."""
    from fsvid2vid_tpu_torch.data.synthetic import write_pose_dataset
    data = write_pose_dataset(str(tmp_path / "pose"), seed=1, n_seqs=2, n_frames=4)
    ckpts = str(tmp_path / "ckpt")
    run_ = cli_train.main(["--name", "pose", "--dataroot", data, "--checkpoints_dir", ckpts,
                           "--batchSize", "2", "--niter", "2", "--niter_decay", "0",
                           "--niter_single", "1", "--no_flow_gt", "--steps_per_epoch", "2",
                           "--num_workers", "2", "--display_freq", "2", "--print_freq", "2",
                           "--device", "cpu"] + POSE + TINY_FLAGS)
    assert run_.cfg.refine_face and run_.trainer.models.netGf is not None
    assert sorted(run_.trainer.epoch_metrics) == [1, 2]
    for metrics in run_.trainer.epoch_metrics.values():
        assert all(np.isfinite(v) for v in metrics.values())
        assert metrics["Gf_GAN"] > 0 and metrics["Df_real"] > 0
    stored = ckpt.load(run_.cfg)["networks"]["Gf"]
    trained = run_.trainer.models.netGf.state_dict()
    assert stored.keys() == trained.keys()

    real, seen = tft.finetune, {}

    def checked(cfg, models, *args, **kw):
        seen["restored"] = all(torch.equal(v, stored[k])
                               for k, v in models.netGf.state_dict().items())
        before = {n: p.detach().clone() for n, p in models.netGf.named_parameters()}
        out = real(cfg, models, *args, **kw)
        mask = tft.finetune_mask(models.netGf)
        moved = {n for n, p in models.netGf.named_parameters() if not torch.equal(p, before[n])}
        seen["moved_in_mask"] = len(moved) > 0 and all(mask[n] for n in moved)
        return out
    monkeypatch.setattr(tft, "finetune", checked)
    res = cli_test.main(["--name", "pose", "--dataroot", data, "--checkpoints_dir", ckpts,
                         "--results_dir", str(tmp_path / "results"), "--device", "cpu",
                         "--how_many", "2", "--finetune",
                         "--seq_path", os.path.join(data, "test_images", "0001/"),
                         "--ref_img_path", os.path.join(data, "test_images", "0002/")]
                        + POSE + TINY_FLAGS)
    assert seen == {"restored": True, "moved_in_mask": True}
    assert len(res.finetune_losses) == 100 and res.nonfinite_frames == []
    assert all(np.isfinite(v) for losses in res.finetune_losses for v in losses.values())
    images = os.listdir(os.path.join(res.web_dir, "images"))
    assert sum("synthesized" in i for i in images) == 2
