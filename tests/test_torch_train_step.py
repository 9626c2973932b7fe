"""The port's train steps against the JAX package's, on the CPU in f32.

One shared initial state at a tiny size (ngf 4, ndf 4, 32 px, three
downsamplings, two adaptive layers, batch 2, VGG loss on): the JAX state is
initialised, every variable of G, D, the temporal D and VGG19 is redrawn from
numpy (`randomize`, activations of order one; spectral u / v random unit
vectors) and carried into the port through the converters.  The teacher's
flows and confidences are numpy inputs to both.  The discriminators' logit
convs are scaled by 4 and their biases raised by 1, so that more fake than
real logits lie in the hinge's active range: while as many real as fake
logits pull on the logit bias its gradient is exactly zero, float noise
decides its sign, and Adam's first update moves the bias by +-lr, which
shifts the step-1 G_GAN loss, taken against the updated D, by 5e-4.

Tolerances:
  * step 1, every key of the losses dict: 1e-4 relative (f32 sums in another
    order through G, D and VGG19);
  * step 1, gradients before Adam, per tensor in the 2-norm:
    |g_port - g_jax| <= 1e-3 |g_jax| for the discriminators and 1e-2 |g_jax|
    for the generator, plus a floor of 1e-6 of the largest tensor norm for
    tensors whose true gradient is zero and hold rounding noise only (a conv
    bias that a norm layer removes).  The generator's bound is looser because
    the VGG loss's gradient is discontinuous in the image (L1 on ReLU
    features behind max-pools): measured on this very state, two fake images
    that differ by 6e-7 give VGG-loss gradients that differ by 1e-2 per tap,
    and so do two CPU convolution backends of one framework; without that
    term the generator's gradients agree to 1e-5.  With beta1 = 0 Adam's
    first moment after step 1 is the gradient itself, which is where the JAX
    side is read;
  * steps 2 and 3, losses: 2e-2 relative.  With beta1 = 0 the first Adam
    update is lr * g / (|g| + eps), a sign function: an element whose gradient
    is rounding noise around 0 moves by +lr in one framework and -lr in the
    other, so the two parameter sets differ by up to 2 lr on such elements
    from step 1 on and later losses agree only loosely;
  * the previous-frames buffers after advance_prevs: 1e-4 at step 1.

The JAX step's compile dominates the time, so each of the three JAX programs
(train_step single-frame, train_step temporal with filled buffers,
train_step_faithful single-frame) is compiled once per module; the two-frame
temporal sequence of the faithful step needs two more and is marked slow.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.config import face_config as jax_face_config
from fsvid2vid_tpu.training import state as jstate
from fsvid2vid_tpu.training import step as jstep
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.training import state as tstate
from fsvid2vid_tpu_torch.training import step as tstep
from fsvid2vid_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax, state_dict_from_jax,
    vgg_state_dict_from_jax)
from tests.test_torch_layers import randomize, to_numpy
from tests.test_torch_train_layers import random_uv

LOSS_RTOL_STEP1 = 1e-4
GRAD_RTOL = {"netG": 1e-2, "netD": 1e-3, "netDT": 1e-3}   # see the module docstring
GRAD_FLOOR = 1e-6
LOSS_RTOL_LATER = 2e-2     # the beta1 = 0 sign effect, see the module docstring
PREVS_ATOL = 1e-4
B, SIZE = 2, 32


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
    return make_shared()


def make_shared(**cfg_kw):
    rng = np.random.RandomState(5)
    jcfg = jax_face_config(**tiny(compute_dtype="float32", **cfg_kw))
    tcfg = tconfig.face_config(**tiny(**cfg_kw))
    h = w = SIZE
    cl = jcfg.gen_input_nc
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    conf = lambda: (rng.rand(B, h, w, 1) > 0.3).astype(np.float32)
    batch = dict(tgt_label=mk(B, h, w, cl), tgt_image=np.tanh(mk(B, h, w, 3)),
                 ref_labels=mk(B, 1, h, w, cl), ref_images=np.tanh(mk(B, 1, h, w, 3)),
                 flow_gt=[2 * mk(B, h, w, 2), 2 * mk(B, h, w, 2)],
                 conf_gt=[conf(), conf()])
    prevs = dict(label=mk(B, h, w, cl), real=np.tanh(mk(B, h, w, 3)),
                 fake=np.tanh(mk(B, h, w, 3)))
    jmodels = jstate.build_models(jcfg)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    st = jstate.init_state(jcfg, jmodels, jax.random.PRNGKey(0), jbatch)

    def redraw(params, aux):
        v = randomize(dict(aux, params=params), rng)
        v = random_uv(v, rng) if "spectral" in v else v
        return v.pop("params"), v

    pG, aG = redraw(st.params_G["G"], st.aux_G["G"])
    params_D, aux_D = {}, {}
    for k in st.params_D:
        params_D[k], aux_D[k] = redraw(st.params_D[k], st.aux_D[k])
        # spread the logits beyond the hinge's linear range (see the docstring)
        logit_conv = params_D[k]["discriminator_0"][f"model{jcfg.n_layers_D + 1}_conv"]
        logit_conv["kernel"] = logit_conv["kernel"] * 4
        logit_conv["bias"] = logit_conv["bias"] + 1.0
    vgg = jax.tree_util.tree_map(lambda a: a * np.float32(np.sqrt(2.0)),
                                 randomize({"params": st.vgg_params}, rng)["params"])
    opt_G, opt_D = jstate.make_optimizers(jcfg)
    st = st.replace(params_G={"G": pG}, aux_G={"G": aG}, params_D=params_D,
                    aux_D=aux_D, vgg_params=vgg,
                    opt_G=opt_G.init({"G": pG}), opt_D=opt_D.init(params_D))
    return Shared(jcfg, tcfg, jmodels, st, batch, prevs)


def port_state(shared) -> tstate.TrainState:
    """A fresh port train state carrying the shared JAX initial state."""
    st = shared.jstate0
    models = tstate.build_models(shared.tcfg, device="cpu")
    models.netG.load_state_dict(state_dict_from_jax(
        to_numpy(dict(st.aux_G["G"], params=st.params_G["G"])), shared.tcfg), strict=True)
    for net, key in ((models.netD, "D"), (models.netDT, "DT")):
        net.load_state_dict(discriminator_state_dict_from_jax(
            to_numpy(dict(st.aux_D[key], params=st.params_D[key]))), strict=True)
    models.vgg.load_state_dict(vgg_state_dict_from_jax(to_numpy(st.vgg_params)),
                               strict=True)
    return tstate.TrainState(shared.tcfg, models)


def tbatch(batch):
    t = lambda x: [t(e) for e in x] if isinstance(x, list) else torch.from_numpy(x)
    return {k: t(v) for k, v in batch.items()}


def run_jax(shared, step_fn, flag_seq, prevs=None):
    """[(state, prevs, losses)] after each step of `flag_seq`."""
    jbatch = jax.tree_util.tree_map(jnp.asarray, shared.batch)
    st = shared.jstate0
    pv = (jstep.init_prevs(shared.jcfg, jbatch) if prevs is None
          else jax.tree_util.tree_map(jnp.asarray, prevs))
    out = []
    for flags in flag_seq:
        st, pv, losses, _ = step_fn(shared.jcfg, shared.jmodels, st, jbatch, pv,
                                    jstep.StepFlags(*flags), jax.random.PRNGKey(1))
        out.append((st, jax.device_get(pv), jax.device_get(losses)))
    return out


def run_port(shared, step_fn, flag_seq, prevs=None):
    """[(grads of the step, prevs, losses)] after each step, and the state."""
    state = port_state(shared)
    batch = tbatch(shared.batch)
    pv = tstep.init_prevs(shared.tcfg, batch) if prevs is None else tbatch(prevs)
    out = []
    for flags in flag_seq:
        pv, losses, _ = step_fn(shared.tcfg, state, batch, pv, tstep.StepFlags(*flags))
        grads = {net: {n: p.grad.clone() for n, p in getattr(state.models, net)
                       .named_parameters() if p.grad is not None}
                 for net in ("netG", "netD", "netDT")}
        out.append((grads, pv, losses))
    return out, state


def assert_losses(got, want, rtol):
    assert set(got) == set(want)
    for key in sorted(want):
        w = float(want[key])
        np.testing.assert_allclose(float(got[key]), w, rtol=rtol, atol=1e-6,
                                   err_msg=key)
    for key in ("G_GAN", "G_GAN_Feat", "G_VGG", "F_Flow", "F_Warp", "F_Mask",
                "D_real", "D_fake"):
        assert float(got[key]) > 0, key


def assert_prevs(got, want, atol):
    for key in ("label", "real", "fake"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=atol, err_msg=key)


def adam_mu(opt_state):
    """The first moment of an optax inject_hyperparams(adam) state."""
    return opt_state.inner_state[0].mu


def assert_grads(shared, port_grads, jax_state1, temporal_d_idle=True):
    """Step-1 gradients per tensor, read on the JAX side from Adam's first
    moment (beta1 = 0 makes it the gradient)."""
    st0 = shared.jstate0
    want = {"netG": state_dict_from_jax(to_numpy(dict(
        st0.aux_G["G"], params=adam_mu(jax_state1.opt_G)["G"])), shared.tcfg)}
    mu_D = adam_mu(jax_state1.opt_D)
    for net, key in (("netD", "D"), ("netDT", "DT")):
        want[net] = discriminator_state_dict_from_jax(to_numpy(dict(
            st0.aux_D[key], params=mu_D[key])))
    checked = 0
    for net, grads in port_grads.items():
        norms = {n: float(np.linalg.norm(want[net][n].numpy())) for n in grads}
        floor = GRAD_FLOOR * max(norms.values(), default=0.0)
        for name, g in grads.items():
            diff = float(np.linalg.norm(g.numpy() - want[net][name].numpy()))
            assert diff <= GRAD_RTOL[net] * norms[name] + floor, (net, name, diff, norms[name])
            checked += norms[name] > 100 * floor
    # with lambda_temp = 0 the temporal D is idle
    assert bool(port_grads["netDT"]) != temporal_d_idle
    assert checked > 100                    # tensors with a real gradient


SINGLE = [(False, False)] * 3


@pytest.mark.parametrize("name", ["train_step", "train_step_faithful"])
def test_three_single_frame_steps(shared, name):
    want = run_jax(shared, getattr(jstep, name), SINGLE)
    got, state = run_port(shared, getattr(tstep, name), SINGLE)
    assert_losses(got[0][2], want[0][2], LOSS_RTOL_STEP1)
    assert_grads(shared, got[0][0], want[0][0])
    assert_prevs(got[0][1], want[0][1], PREVS_ATOL)
    for i in (1, 2):
        assert_losses(got[i][2], want[i][2], LOSS_RTOL_LATER)
    assert state.step == 3 and int(want[2][0].step) == 3


def test_temporal_step_with_filled_buffers(shared):
    """warp_prev and has_prev on: the prev flow branch, its warp, the third
    SPADE map and both flow losses, from numpy-drawn previous frames."""
    flags = [(True, True)]
    want = run_jax(shared, jstep.train_step, flags, shared.prevs)
    got, _ = run_port(shared, tstep.train_step, flags, shared.prevs)
    assert_losses(got[0][2], want[0][2], LOSS_RTOL_STEP1)
    assert_grads(shared, got[0][0], want[0][0])
    assert_prevs(got[0][1], want[0][1], PREVS_ATOL)
    # the prev branch doubles the flow terms
    single = run_port(shared, tstep.train_step, [(False, False)])[0][0][2]
    assert float(got[0][2]["F_Warp"]) > 1.5 * float(single["F_Warp"])


@pytest.mark.slow
def test_two_frame_temporal_sequence_faithful(shared):
    """The temporal phase as the trainer drives it: frame 0 without previous
    frames, frame 1 with the buffers frame 0 left."""
    flags = [(True, False), (True, True)]
    want = run_jax(shared, jstep.train_step_faithful, flags)
    got, _ = run_port(shared, tstep.train_step_faithful, flags)
    assert_losses(got[0][2], want[0][2], LOSS_RTOL_STEP1)
    assert_prevs(got[0][1], want[0][1], PREVS_ATOL)
    assert_losses(got[1][2], want[1][2], LOSS_RTOL_LATER)


@pytest.mark.slow
def test_temporal_gan_loss(rng):
    """lambda_temp > 0: the temporal discriminator sees the channel-stacked
    previous and current frames, in both phases."""
    shared = make_shared(lambda_temp=1.0)
    flags = [(True, True)]
    want = run_jax(shared, jstep.train_step, flags, shared.prevs)
    got, _ = run_port(shared, tstep.train_step, flags, shared.prevs)
    assert_losses(got[0][2], want[0][2], LOSS_RTOL_STEP1)
    for key in ("GT_GAN", "GT_GAN_Feat", "DT_real", "DT_fake"):
        assert float(got[0][2][key]) > 0, key
    assert_grads(shared, got[0][0], want[0][0], temporal_d_idle=False)


def test_u_v_advance_once_or_twice_per_step(shared):
    """After one step the port's spectral u / v and batch statistics equal
    the JAX state's: advanced once by train_step (D's G-phase pass is not
    kept) and twice by train_step_faithful."""
    for name in ("train_step", "train_step_faithful"):
        jst = run_jax(shared, getattr(jstep, name), SINGLE[:1])[0][0]
        _, state = run_port(shared, getattr(tstep, name), SINGLE[:1])
        want = discriminator_state_dict_from_jax(to_numpy(dict(
            jst.aux_D["D"], params=jst.params_D["D"])))
        got = state.models.netD.state_dict()
        for key in got:
            if key.endswith(("weight_u", "weight_v")):
                np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                           atol=1e-4, err_msg=f"{name} D {key}")
        wantG = state_dict_from_jax(to_numpy(dict(
            jst.aux_G["G"], params=jst.params_G["G"])), shared.tcfg)
        gotG = state.models.netG.state_dict()
        for key in gotG:
            if key.endswith(("weight_u", "weight_v", "running_mean", "running_var")):
                np.testing.assert_allclose(gotG[key].numpy(), wantG[key].numpy(),
                                           atol=1e-4, err_msg=f"{name} G {key}")


def test_learning_rates_and_epoch_decay(shared):
    cfg = shared.tcfg
    state = port_state(shared)
    lr = lambda opt: opt.param_groups[0]["lr"]
    assert lr(state.opt_G) == cfg.lr / 2 and lr(state.opt_D) == cfg.lr * 2
    assert state.opt_G.defaults["betas"] == (0.0, cfg.beta2)
    for epoch in (1, cfg.niter, cfg.niter + 1, cfg.niter + cfg.niter_decay):
        assert tstate.lr_for_epoch(cfg, epoch) == pytest.approx(
            jstate.lr_for_epoch(shared.jcfg, epoch))
    tstate.set_epoch_lr(cfg, state, cfg.niter + 10)
    base = tstate.lr_for_epoch(cfg, cfg.niter + 10)
    assert base < cfg.lr
    assert lr(state.opt_G) == pytest.approx(base / 2)
    assert lr(state.opt_D) == pytest.approx(base * 2)
    no_ttur = tstate.TrainState(cfg.replace(no_TTUR=True), state.models)
    assert lr(no_ttur.opt_G) == lr(no_ttur.opt_D) == cfg.lr
    assert no_ttur.opt_G.defaults["betas"] == (cfg.beta1, 0.999)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(shared):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstate.build_models(shared.tcfg)


@pytest.mark.parametrize("kw", [dict(use_pool=True)])
def test_unported_step_options_raise(shared, kw):
    """The replay pool is ported (tests/test_torch_trainer.py holds it
    against the JAX step); a pool step without the pool's inputs raises."""
    state = port_state(shared)
    batch = tbatch(shared.batch)
    with pytest.raises(ValueError, match="pool_fake and pool_mask"):
        tstep.train_step(shared.tcfg, state, batch,
                         tstep.init_prevs(shared.tcfg, batch), tstep.StepFlags(**kw))
