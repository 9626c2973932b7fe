"""The port's street path against the JAX package's, on the CPU in f32, at a
tiny street configuration: ngf 4, ndf 4, three downsamplings, 20 label
classes, no warp_ref and no spade_combine (street_config), VGG loss on.

The JAX street path takes its labels as they come, and its loader gives
class indices (ROADMAP.md C: the JAX package never calls `encode_label` on
the street path).  The reference one-hot encodes them (encode_input), and so
does the port, inside the step and the pipeline.  So every comparison feeds
the port the index labels and the JAX package `encode_label` of the same
labels:

  * `encode_label` itself, bit for bit;
  * the eval forward through `run_sequence` and the K = 1
    `InferencePipeline`, 1e-4 on images (tests/test_torch_generator.py's
    tolerance), at 16 x 32;
  * step 1 of `train_step`, single-frame and temporal, at 64 x 128 (the
    smallest street size with a FlowNet2 grid): the street teacher's flow
    to the previous frame on the real images against the JAX teacher (1e-3
    of the flows' maximum, as tests/test_torch_flownet.py), then every loss
    at 1e-4 relative and the previous-frames buffers at 1e-4, as
    tests/test_torch_pose_step.py.  Both steps take the JAX teacher's
    flows, so the step comparison is about the step.  Without
    spade_combine the temporal frame's raw image is scored beside the final
    one, so each discriminator runs twice per phase from the same spectral
    u / v (training/step.py `_from_start`).

The JAX state is shaped by `jax.eval_shape` of its init on a one-hot batch
and every variable redrawn from numpy, with the discriminators' logits
spread past the hinge's kinks (tests/test_torch_train_step.py explains
why), and carried into the port through the converters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.config import street_config as jstreet
from fsvid2vid_tpu.inference.pipeline import run_sequence as jax_run_sequence
from fsvid2vid_tpu.models.flownet.flownet2 import FlowNet2 as JaxFlowNet2
from fsvid2vid_tpu.models.generator import FewShotGenerator as JaxGenerator
from fsvid2vid_tpu.models.input_process import encode_label as jax_encode_label
from fsvid2vid_tpu.training import flow_teacher as jteacher
from fsvid2vid_tpu.training import state as jstate
from fsvid2vid_tpu.training import step as jstep
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.inference.pipeline import InferencePipeline, run_sequence
from fsvid2vid_tpu_torch.models import build_generator
from fsvid2vid_tpu_torch.models.input_process import encode_label
from fsvid2vid_tpu_torch.training import flow_teacher as tteacher
from fsvid2vid_tpu_torch.training import state as tstate
from fsvid2vid_tpu_torch.training import step as tstep
from fsvid2vid_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax, flownet2_state_dict_from_jax,
    state_dict_from_jax, vgg_state_dict_from_jax)
from tests.test_torch_data import few_threads  # noqa: F401 (autouse)
from tests.test_torch_layers import randomize, to_numpy
from tests.test_torch_train_layers import random_uv

LOSS_RTOL = 1e-4
PREVS_ATOL = 1e-4
# The temporal frame warps the previous fake, a noise image (gradients up to
# ~2 per pixel), by the generator's flow, which at random weights reaches
# ~110 pixels: the flows agree to 1e-5 of their maximum (f32 rounding), and
# the ~1e-4-pixel differences that leaves move the warped noise, and the
# fake blended from it, by up to ~3e-4.
FLOW_GEN_REL = 1e-5
WARPED_ATOL = 5e-4
IMG_ATOL = 1e-4
FLOW_REL = 1e-3
B = 2
D_NETS = ("D", "DT")


def tiny(fine_size, **kw):
    return dict(ngf=4, nff=4, ndf=4, fine_size=fine_size, load_size=fine_size,
                n_blocks_F=2, n_downsample_G=3, n_adaptive_layers=2, batch_size=B, **kw)


def street_labels(rng, *lead_hw):
    """Class indices (*lead, H, W, 1) in [0, 20) of 8 x 8-pixel blocks, f32
    as the street loader gives them."""
    *lead, h, w = lead_hw
    blocks = rng.randint(0, 20, (*lead, h // 8, w // 8))
    return blocks.repeat(8, -2).repeat(8, -1)[..., None].astype(np.float32)


def tbatch(batch):
    """numpy -> tensors, through lists, keeping None."""
    t = lambda x: (None if x is None else [t(e) for e in x] if isinstance(x, list)
                   else torch.from_numpy(np.array(x)))
    return {k: t(v) for k, v in batch.items()}


def onehot(cfg, label):
    return np.asarray(jax_encode_label(cfg, jnp.asarray(label)))


def test_encode_label_equals_jax():
    """(B, K, H, W, 1) indices -> 20 channels, bit for bit; label_nc 0
    passes the label through."""
    rng = np.random.RandomState(0)
    label = street_labels(rng, 2, 3, 16, 32)
    jcfg, tcfg = jstreet(), tconfig.street_config()
    got = encode_label(tcfg, torch.from_numpy(label))
    want = onehot(jcfg, label)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 16, 32, 20)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.sum(-1) == 1).all()
    face = tconfig.face_config()
    x = torch.from_numpy(rng.randn(1, 8, 8, 1).astype(np.float32))
    assert encode_label(face, x) is x


@pytest.mark.parametrize("path", ["run_sequence", "pipeline"])
def test_street_eval_forward_matches_jax(path):
    """Three frames at 16 x 32: the port fed class indices (run_sequence, or
    InferencePipeline.reset + step) against JAX run_sequence fed their
    one-hot encoding."""
    rng = np.random.RandomState(6)
    jcfg = jstreet(**dict(tiny(32, is_train=False), batch_size=1))
    tcfg = tconfig.Config.from_json(jcfg.to_json())
    h, w = jcfg.height, jcfg.width
    labels = street_labels(rng, 3, 1, h, w)
    ref_labels = street_labels(rng, 1, 1, h, w)
    ref_images = np.tanh(rng.randn(1, 1, h, w, 3)).astype(np.float32)
    jlabels, jref_labels = onehot(jcfg, labels), onehot(jcfg, ref_labels)
    jm = JaxGenerator(jcfg)
    shapes = jax.eval_shape(lambda *a: jm.init(*a, warp_prev=True, train=False),
                            jax.random.PRNGKey(0), *map(jnp.asarray, (
                                jlabels[0], jref_labels, ref_images, jlabels[1],
                                ref_images[:, 0])))
    v = randomize(shapes, rng)
    models = dataclasses.replace(jstate.build_models(jcfg), netG=jm)
    want = np.asarray(jax_run_sequence(
        jcfg, models, {"G": v["params"]}, {"G": {c: x for c, x in v.items() if c != "params"}},
        jnp.asarray(jlabels), jnp.asarray(jref_labels), jnp.asarray(ref_images)))
    g = build_generator(tcfg, device="cpu")
    g.load_state_dict(state_dict_from_jax(to_numpy(v), tcfg), strict=True)
    if path == "run_sequence":
        got = run_sequence(tcfg, g, labels, ref_labels, ref_images).numpy()
    else:
        pipe = InferencePipeline(tcfg, g)
        pipe.reset(ref_labels, ref_images, labels[0])
        assert pipe.prevs["label"].shape == (1, h, w, 20)
        got = np.stack([pipe.step(label)["fake_image"].numpy() for label in labels])
    assert got.shape == want.shape == (3, 1, h, w, 3)
    assert want.std() > 0.02
    np.testing.assert_allclose(got, want, atol=IMG_ATOL)


@dataclasses.dataclass
class Shared:
    jcfg: object
    tcfg: object
    jmodels: object
    jstate0: object
    batch: dict          # index labels, the JAX teacher's flow to the previous frame
    prev_frame: dict     # frame 0 of the sequence, labels index
    teacher: tuple       # (JAX flows, port flows) of the sequence


@pytest.fixture(scope="module")
def shared():
    rng = np.random.RandomState(9)
    jcfg = jstreet(**tiny(128, compute_dtype="float32"))
    tcfg = tconfig.street_config(**tiny(128))
    assert not (tcfg.warp_ref or tcfg.spade_combine) and tcfg.label_nc == 20
    h, w = jcfg.height, jcfg.width
    assert (h, w) == (64, 128)
    seq = dict(tgt_label=street_labels(rng, B, 2, h, w),
               tgt_image=np.tanh(rng.randn(B, 2, h, w, 3)).astype(np.float32),
               ref_labels=street_labels(rng, B, 1, h, w),
               ref_images=np.tanh(rng.randn(B, 1, h, w, 3)).astype(np.float32))
    # the teacher on the real images, temporal phase: the flow to frame 0
    x = jnp.zeros((1, 64, 64, 3))
    flownet = randomize({"params": jax.eval_shape(
        lambda: JaxFlowNet2().init(jax.random.PRNGKey(0), x, x))["params"]}, rng)["params"]
    epoch = jcfg.niter_single + 1
    jflow, jconf = jteacher.FlowTeacher(jcfg, params=flownet)(jcfg, seq, epoch)
    tt = tteacher.FlowTeacher(tcfg, device="cpu",
                              state_dict=flownet2_state_dict_from_jax(to_numpy(flownet)))
    tflow, _ = tt(tcfg, {k: torch.from_numpy(v) for k, v in seq.items()}, epoch)
    flow, conf = np.asarray(jflow[1])[:, 1], np.asarray(jconf[1])[:, 1]
    batch = dict(tgt_label=seq["tgt_label"][:, 1], tgt_image=seq["tgt_image"][:, 1],
                 ref_labels=seq["ref_labels"], ref_images=seq["ref_images"],
                 flow_gt=[None, flow], conf_gt=[None, conf])
    prev_frame = dict(label=seq["tgt_label"][:, 0], real=seq["tgt_image"][:, 0],
                      fake=np.tanh(rng.randn(B, h, w, 3)).astype(np.float32))

    jmodels = jstate.build_models(jcfg)
    st = redrawn_state(jcfg, jmodels, jax_batch(jcfg, batch), rng)
    assert set(st.params_D) == set(D_NETS)
    return Shared(jcfg, tcfg, jmodels, st, batch, prev_frame, (jflow, tflow))


def redrawn_state(jcfg, jmodels, jbatch, rng):
    """A JAX train state shaped by its init on `jbatch`, every variable of
    G, the discriminators and VGG19 redrawn from numpy; the discriminators'
    logits spread past the hinge's kinks (tests/test_torch_train_step.py)."""
    st = jax.eval_shape(lambda: jstate.init_state(jcfg, jmodels, jax.random.PRNGKey(0),
                                                  jbatch))

    def redraw(params, aux):
        v = randomize(dict(aux, params=params), rng)
        v = random_uv(v, rng) if "spectral" in v else v
        return v.pop("params"), v

    pG, aG = redraw(st.params_G["G"], st.aux_G["G"])
    params_D, aux_D = {}, {}
    for k in st.params_D:
        params_D[k], aux_D[k] = redraw(st.params_D[k], st.aux_D[k])
        logit_conv = params_D[k]["discriminator_0"][f"model{jcfg.n_layers_D + 1}_conv"]
        logit_conv["kernel"] = logit_conv["kernel"] * 4
        logit_conv["bias"] = logit_conv["bias"] + 1.0
    vgg = jax.tree_util.tree_map(lambda a: a * np.float32(np.sqrt(2.0)),
                                 randomize({"params": st.vgg_params}, rng)["params"])
    opt_G, opt_D = jstate.make_optimizers(jcfg)
    return jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params_G={"G": pG}, aux_G={"G": aG},
        params_D=params_D, aux_D=aux_D, vgg_params=vgg,
        opt_G=opt_G.init({"G": pG}), opt_D=opt_D.init(params_D))


def port_models(tcfg, st):
    """The port's networks of `tcfg` on the CPU, holding the JAX state's
    variables."""
    models = tstate.build_models(tcfg, device="cpu")
    models.netG.load_state_dict(state_dict_from_jax(
        to_numpy(dict(st.aux_G["G"], params=st.params_G["G"])), tcfg), strict=True)
    for key in st.params_D:
        getattr(models, "net" + key).load_state_dict(discriminator_state_dict_from_jax(
            to_numpy(dict(st.aux_D[key], params=st.params_D[key]))), strict=True)
    models.vgg.load_state_dict(vgg_state_dict_from_jax(to_numpy(st.vgg_params)),
                               strict=True)
    return models


def jax_batch(jcfg, batch):
    """The JAX step's batch: the labels one-hot encoded, as arrays."""
    b = dict(batch, tgt_label=onehot(jcfg, batch["tgt_label"]),
             ref_labels=onehot(jcfg, batch["ref_labels"]))
    return jax.tree_util.tree_map(jnp.asarray, b)


def port_state(shared) -> tstate.TrainState:
    return tstate.TrainState(shared.tcfg, port_models(shared.tcfg, shared.jstate0))


def test_street_teacher_matches_jax(shared):
    """The flow to the previous frame on the real images at 64 x 128; no
    flow to the reference (no warp_ref)."""
    jflow, tflow = shared.teacher
    assert jflow[0] is None and tflow[0] is None
    want = np.asarray(jflow[1])
    assert tflow[1].shape == want.shape == (B, 2, 64, 128, 2)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(tflow[1].numpy(), want, atol=FLOW_REL * scale)


@pytest.mark.parametrize("temporal", [False, True], ids=["single_frame", "temporal"])
def test_step_one_losses_match_jax(shared, temporal):
    """train_step's first step: the port fed index labels against the JAX
    step fed their one-hot encoding; the previous-label buffer holds 20
    channels on both sides."""
    jcfg, tcfg = shared.jcfg, shared.tcfg
    batch = shared.batch if temporal else dict(shared.batch, flow_gt=[None, None],
                                               conf_gt=[None, None])
    jbatch = jax_batch(jcfg, batch)
    if temporal:
        prevs = dict(shared.prev_frame, label=onehot(jcfg, shared.prev_frame["label"]))
    else:
        prevs = {k: np.array(v) for k, v in jstep.init_prevs(jcfg, jbatch).items()}
    flags = (temporal, temporal)
    _, jpv, jlosses, jvis = jstep.train_step(
        jcfg, shared.jmodels, shared.jstate0, jbatch,
        jax.tree_util.tree_map(jnp.asarray, prevs), jstep.StepFlags(*flags),
        jax.random.PRNGKey(1))
    want, jpv, jvis = (jax.device_get(x) for x in (jlosses, jpv, jvis))
    state = port_state(shared)
    tb = tbatch(batch)
    if not temporal:
        port_prevs = tstep.init_prevs(tcfg, tb)
        assert {k: v.shape for k, v in port_prevs.items()} == {
            k: v.shape for k, v in prevs.items()}
    pv, got, visuals = tstep.train_step(tcfg, state, tb, tbatch(prevs),
                                        tstep.StepFlags(*flags))
    assert set(got) == set(want)
    for key in sorted(want):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=key)
    positive = ["G_GAN", "G_GAN_Feat", "G_VGG", "D_real", "D_fake"]
    if temporal:
        positive += ["F_Warp", "F_Mask"] + (["F_Flow"] if batch["conf_gt"][1].any() else [])
    for key in positive:
        assert float(got[key]) > 0, key
    assert pv["label"].shape[-1] == 20
    for key in ("label", "real"):
        np.testing.assert_allclose(pv[key].numpy(), jpv[key], atol=PREVS_ATOL, err_msg=key)
    np.testing.assert_allclose(visuals["fake_raw" if temporal else "fake_image"].numpy(),
                               jvis["fake_raw" if temporal else "fake_image"],
                               atol=PREVS_ATOL)
    if temporal:
        flow = jvis["flow"][1]
        np.testing.assert_allclose(visuals["flow"][1].numpy(), flow,
                                   atol=FLOW_GEN_REL * np.abs(flow).max())
    np.testing.assert_allclose(pv["fake"].numpy(), jpv["fake"],
                               atol=WARPED_ATOL if temporal else PREVS_ATOL)
    assert visuals["tgt_label"].shape[-1] == 20
