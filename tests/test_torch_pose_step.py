"""The port's pose training against the JAX package's, on the CPU in f32, at
a tiny pose configuration: ngf 4, ndf 4, 64 x 32 (fine_size 32 at the pose
aspect ratio 0.5), three downsamplings, batch 2, 6-channel DensePose +
OpenPose labels with remove_face_labels, the face discriminator on 16 x 16
face crops (add_face_D), VGG loss on, remat on; refine_face off.

  * step 1 of `train_step` (temporal, with numpy-drawn previous frames) and
    of `train_step_faithful` (single frame): every key of the losses dict,
    Df_* and Gf_* included, 1e-4 relative (f32 sums in another order through
    G, the three discriminators and VGG19, as tests/test_torch_train_step.py),
    and the previous-frames buffers, 1e-4;
  * the pose flow teacher (flow on the labels' DensePose channels) against
    the JAX teacher at 128 x 64 (FlowNet2's grid is 64 pixels, so the 64 x 32
    size has no teacher): flows to 1e-3 of their maximum, as
    tests/test_torch_flownet.py;
  * the pose eval forward of the generator through `run_sequence`, 1e-4 on
    images (tests/test_torch_generator.py's tolerance);
  * remat changes no loss and no gradient: 1e-6 on gradients, port only.

The JAX state is initialised, every variable of G, D, the temporal D, the
face D and VGG19 redrawn from numpy and carried into the port through the
converters, with the discriminators' logits spread past the hinge's kinks as
tests/test_torch_train_step.py explains.  Each JAX program is compiled once
per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.config import pose_config as jpose
from fsvid2vid_tpu.inference.pipeline import run_sequence as jax_run_sequence
from fsvid2vid_tpu.models.flownet.flownet2 import FlowNet2 as JaxFlowNet2
from fsvid2vid_tpu.models.generator import FewShotGenerator as JaxGenerator
from fsvid2vid_tpu.training import flow_teacher as jteacher
from fsvid2vid_tpu.training import state as jstate
from fsvid2vid_tpu.training import step as jstep
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.inference.pipeline import run_sequence
from fsvid2vid_tpu_torch.models import build_generator
from fsvid2vid_tpu_torch.training import flow_teacher as tteacher
from fsvid2vid_tpu_torch.training import state as tstate
from fsvid2vid_tpu_torch.training import step as tstep
from fsvid2vid_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax, flownet2_state_dict_from_jax,
    state_dict_from_jax, vgg_state_dict_from_jax)
from tests.test_torch_layers import randomize, to_numpy
from tests.test_torch_pose_losses import pose_label
from tests.test_torch_train_layers import random_uv
from tests.test_torch_train_step import adam_mu, assert_prevs, tbatch

LOSS_RTOL = 1e-4
PREVS_ATOL = 1e-4
IMG_ATOL = 1e-4
FLOW_REL = 1e-3
REMAT_GRAD_ATOL = 1e-6
B, SIZE = 2, 32
D_NETS = ("D", "DT", "Df")


def tiny(**kw):
    return dict(ngf=4, nff=4, ndf=4, fine_size=SIZE, load_size=SIZE, n_blocks_F=2,
                n_downsample_G=3, n_adaptive_layers=2, batch_size=B, **kw)


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
    rng = np.random.RandomState(8)
    jcfg = jpose(**tiny(compute_dtype="float32"))
    tcfg = tconfig.pose_config(**tiny())
    assert jcfg.remat and tcfg.remat and tcfg.add_face_D and tcfg.remove_face_labels
    h, w = jcfg.height, jcfg.width
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    conf = lambda: (rng.rand(B, h, w, 1) > 0.3).astype(np.float32)
    batch = dict(tgt_label=pose_label(rng, B, h, w), tgt_image=np.tanh(mk(B, h, w, 3)),
                 ref_labels=pose_label(rng, B, h, w, shift=3)[:, None],
                 ref_images=np.tanh(mk(B, 1, h, w, 3)),
                 flow_gt=[2 * mk(B, h, w, 2), 2 * mk(B, h, w, 2)],
                 conf_gt=[conf(), conf()])
    prevs = dict(label=pose_label(rng, B, h, w, shift=1), real=np.tanh(mk(B, h, w, 3)),
                 fake=np.tanh(mk(B, h, w, 3)))
    jmodels = jstate.build_models(jcfg)
    st = jax.eval_shape(lambda: jstate.init_state(
        jcfg, jmodels, jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, batch)))
    assert set(st.params_D) == set(D_NETS)

    def redraw(params, aux):
        v = randomize(dict(aux, params=params), rng)
        v = random_uv(v, rng) if "spectral" in v else v
        return v.pop("params"), v

    pG, aG = redraw(st.params_G["G"], st.aux_G["G"])
    params_D, aux_D = {}, {}
    for k in D_NETS:
        params_D[k], aux_D[k] = redraw(st.params_D[k], st.aux_D[k])
        logit_conv = params_D[k]["discriminator_0"][f"model{jcfg.n_layers_D + 1}_conv"]
        logit_conv["kernel"] = logit_conv["kernel"] * 4
        logit_conv["bias"] = logit_conv["bias"] + 1.0
    vgg = jax.tree_util.tree_map(lambda a: a * np.float32(np.sqrt(2.0)),
                                 randomize({"params": st.vgg_params}, rng)["params"])
    opt_G, opt_D = jstate.make_optimizers(jcfg)
    st = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params_G={"G": pG}, aux_G={"G": aG},
        params_D=params_D, aux_D=aux_D, vgg_params=vgg,
        opt_G=opt_G.init({"G": pG}), opt_D=opt_D.init(params_D))
    return Shared(jcfg, tcfg, jmodels, st, batch, prevs)


def port_state(shared, **cfg_kw) -> tstate.TrainState:
    st = shared.jstate0
    cfg = shared.tcfg.replace(**cfg_kw)
    models = tstate.build_models(cfg, device="cpu")
    models.netG.load_state_dict(state_dict_from_jax(
        to_numpy(dict(st.aux_G["G"], params=st.params_G["G"])), cfg), strict=True)
    for key in D_NETS:
        getattr(models, "net" + key).load_state_dict(discriminator_state_dict_from_jax(
            to_numpy(dict(st.aux_D[key], params=st.params_D[key]))), strict=True)
    models.vgg.load_state_dict(vgg_state_dict_from_jax(to_numpy(st.vgg_params)),
                               strict=True)
    return tstate.TrainState(cfg, models)


def run_both(shared, name, flags, prevs):
    jst, jpv, jlosses, _ = getattr(jstep, name)(
        shared.jcfg, shared.jmodels, shared.jstate0,
        jax.tree_util.tree_map(jnp.asarray, shared.batch),
        jax.tree_util.tree_map(jnp.asarray, prevs), jstep.StepFlags(*flags),
        jax.random.PRNGKey(1))
    state = port_state(shared)
    pv, losses, _ = getattr(tstep, name)(shared.tcfg, state, tbatch(shared.batch),
                                         tbatch(prevs), tstep.StepFlags(*flags))
    return (jst, jax.device_get(jpv), jax.device_get(jlosses)), (state, pv, losses)


@pytest.mark.parametrize("name,flags", [("train_step", (True, True)),
                                        ("train_step_faithful", (False, False))])
def test_step_one_losses_match_jax(shared, name, flags):
    prevs = shared.prevs if flags[1] else {k: np.array(v) for k, v in jstep.init_prevs(
        shared.jcfg, jax.tree_util.tree_map(jnp.asarray, shared.batch)).items()}
    (jst, jpv, want), (state, pv, got) = run_both(shared, name, flags, prevs)
    assert set(got) == set(want)
    for key in sorted(want):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=key)
    for key in ("G_GAN", "G_GAN_Feat", "G_VGG", "Gf_GAN", "Gf_GAN_Feat", "F_Flow",
                "F_Warp", "F_Mask", "D_real", "D_fake", "Df_real", "Df_fake"):
        assert float(got[key]) > 0, key
    assert_prevs(pv, jpv, PREVS_ATOL)
    # the face D trained: its Adam moment is the JAX step's (beta1 = 0: the gradient)
    mu = discriminator_state_dict_from_jax(to_numpy(dict(
        shared.jstate0.aux_D["Df"], params=adam_mu(jst.opt_D)["Df"])))
    grads = {n: p.grad for n, p in state.models.netDf.named_parameters()}
    assert grads and all(g is not None for g in grads.values())
    for n, g in grads.items():
        want_g = mu[n].numpy()
        assert np.linalg.norm(g.numpy() - want_g) <= 1e-3 * np.linalg.norm(want_g) + 1e-8, n


def test_remat_changes_no_gradient(shared):
    """The same temporal step with and without remat: equal losses, equal
    gradients of every G and D tensor, equal buffers after the step."""
    out = {}
    for remat in (True, False):
        state = port_state(shared, remat=remat)
        _, losses, _ = tstep.train_step(state.cfg, state, tbatch(shared.batch),
                                        tbatch(shared.prevs), tstep.StepFlags(True, True))
        grads = {f"{net}.{n}": p.grad.clone() for net in ("netG", "netD", "netDf")
                 for n, p in getattr(state.models, net).named_parameters()
                 if p.grad is not None}
        buffers = {n: b.clone() for n, b in state.models.netG.named_buffers()}
        out[remat] = losses, grads, buffers
    (l1, g1, b1), (l0, g0, b0) = out[True], out[False]
    assert l1.keys() == l0.keys() and all(torch.equal(l1[k], l0[k]) for k in l0)
    assert g1.keys() == g0.keys() and len(g0) > 200
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], atol=REMAT_GRAD_ATOL, rtol=0, msg=k)
    for k in b0:
        assert torch.equal(b1[k], b0[k]), k


def test_pose_teacher_matches_jax():
    """Flow on the first three (DensePose) channels of the raw labels, not on
    the images; at 128 x 64, both phases."""
    rng = np.random.RandomState(4)
    kw = dict(fine_size=64, load_size=64)
    jcfg, tcfg = jpose(**kw), tconfig.pose_config(**kw)
    h, w = jcfg.height, jcfg.width
    jm = JaxFlowNet2()
    x = jnp.zeros((1, 64, 64, 3))
    params = randomize({"params": jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), x, x))["params"]}, rng)["params"]
    labels = np.stack([pose_label(rng, 1, h, w, shift=s)[0] for s in (0, 1, 2)])[None]
    seq = {"tgt_label": labels[:, :2], "ref_labels": labels[:, 2:],
           "tgt_image": np.tanh(rng.randn(1, 2, h, w, 3)).astype(np.float32),
           "ref_images": np.tanh(rng.randn(1, 1, h, w, 3)).astype(np.float32)}
    epoch = jcfg.niter_single + 1
    jflow, _ = jteacher.FlowTeacher(jcfg, params=params)(jcfg, seq, epoch)
    tt = tteacher.FlowTeacher(tcfg, device="cpu",
                              state_dict=flownet2_state_dict_from_jax(to_numpy(params)))
    tseq = {k: torch.from_numpy(v) for k, v in seq.items()}
    flow, conf = tt(tcfg, tseq, epoch)
    for i in range(2):
        want = np.asarray(jflow[i])
        assert flow[i].shape == (1, 2, h, w, 2) and conf[i].shape == (1, 2, h, w, 1)
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(flow[i].numpy(), want, atol=FLOW_REL * scale)
    # the images do not enter: other images, the same flows
    other = dict(tseq, tgt_image=-tseq["tgt_image"], ref_images=-tseq["ref_images"])
    flow2, _ = tt(tcfg, other, epoch)
    assert all(torch.equal(a, b) for a, b in zip(flow, flow2))


def test_pose_eval_forward_matches_jax():
    """run_sequence over 3 frames of 6-channel pose labels: use_valid_labels
    blanks the face parts (remove_face_labels) on both sides."""
    rng = np.random.RandomState(6)
    jcfg = jpose(**dict(tiny(is_train=False), batch_size=1))
    tcfg = tconfig.Config.from_json(jcfg.to_json())
    h, w = jcfg.height, jcfg.width
    labels = np.stack([pose_label(rng, 1, h, w, shift=t) for t in range(3)])
    ref_labels = pose_label(rng, 1, h, w, shift=2)[:, None]
    ref_images = np.tanh(rng.randn(1, 1, h, w, 3)).astype(np.float32)
    jm = JaxGenerator(jcfg)
    shapes = jax.eval_shape(lambda *a: jm.init(*a, warp_prev=True, train=False),
                            jax.random.PRNGKey(0), *map(jnp.asarray, (
                                labels[0], ref_labels, ref_images, labels[1],
                                ref_images[:, 0])))
    v = randomize(shapes, rng)
    models = dataclasses.replace(jstate.build_models(jcfg), netG=jm)
    want = np.asarray(jax_run_sequence(
        jcfg, models, {"G": v["params"]}, {"G": {c: x for c, x in v.items() if c != "params"}},
        jnp.asarray(labels), jnp.asarray(ref_labels), jnp.asarray(ref_images)))
    g = build_generator(tcfg, device="cpu")
    g.load_state_dict(state_dict_from_jax(to_numpy(v), tcfg), strict=True)
    got = run_sequence(tcfg, g, labels, ref_labels, ref_images).numpy()
    assert got.shape == want.shape == (3, 1, h, w, 3)
    assert want.std() > 0.02
    np.testing.assert_allclose(got, want, atol=IMG_ATOL)


def test_open_pose_type_trains(shared):
    """pose_type 'open': the generator takes the three OpenPose channels of
    the valid labels, D the target's 3 + the reference's raw 6 label
    channels (the JAX modules infer both from their inputs), and the
    previous-label buffer holds 3 channels a frame."""
    cfg = shared.tcfg.replace(pose_type="open")
    assert (cfg.gen_input_nc, cfg.netD_input_nc) == (3, (3 + 3 + 1) + (6 + 3 + 1))
    state = tstate.TrainState(cfg, tstate.build_models(cfg, device="cpu"))
    batch = tbatch(shared.batch)
    prevs = tstep.init_prevs(cfg, batch)
    assert prevs["label"].shape[-1] == 3
    for flags in ((False, False), (True, True)):
        prevs, losses, _ = tstep.train_step(cfg, state, batch, prevs, tstep.StepFlags(*flags))
        assert all(torch.isfinite(v) for v in losses.values())
        assert float(losses["Df_real"]) > 0 and prevs["label"].shape[-1] == 3
