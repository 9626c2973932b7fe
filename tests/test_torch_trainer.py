"""The port's trainer against the JAX package's, on the CPU in f32.

One shared initial state at a tiny size (ngf 4, ndf 4, 32 px, three
downsamplings, batch 1 so that the JAX trainer builds no mesh): the JAX
train state is shaped by `jax.eval_shape` of its init and every variable is
redrawn from numpy, as tests/test_torch_train_step.py does (with its
discriminator logit spread, for the reason its docstring gives), and carried
into the port through the converters.  A stub flow teacher derives the
flows from the images, the same function on both sides.

Tolerances: losses 1e-4 relative (f32 sums in another order through G, D
and VGG19, as in tests/test_torch_train_step.py); the curriculum and the
temporal copy exactly; the port's trainer against its own step run by hand
bitwise.  The JAX step with the replay pool is compiled once and shared by
the pool test and the JAX trainer (same program, batch and flags).
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
from fsvid2vid_tpu.training import trainer as jtrainer
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.training import state as tstate
from fsvid2vid_tpu_torch.training import step as tstep
from fsvid2vid_tpu_torch.training import trainer as ttrainer
from fsvid2vid_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax, state_dict_from_jax,
    vgg_state_dict_from_jax)
from tests.test_torch_layers import randomize, to_numpy
from tests.test_torch_data import few_threads  # noqa: F401 (autouse)
from tests.test_torch_train_layers import random_uv

LOSS_RTOL = 1e-4
B, SIZE = 1, 32
# Adam's first step moves every parameter by +-lr whatever its gradient's
# size (beta1 = 0), so a G loss taken after the D update depends on the sign
# of every D gradient element.  Here a 3e-5 difference between the two
# frameworks' generated images (f32 rounding through G) changes D's
# first-layer gradients by ~8 %, enough to flip a few signs: at the default
# lr that moves G_GAN by 2e-3 relative.  A small lr keeps the step-1
# comparison about the code, not about those signs.
LR = 1e-6


def tiny(**kw):
    return dict(ngf=4, nff=4, ndf=4, fine_size=SIZE, load_size=SIZE, n_blocks_F=2,
                n_downsample_G=3, n_adaptive_layers=2, batch_size=B, **kw)


def sequences(seed, n, t):
    """n loader batches of t frames, numpy, channel-last."""
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    return [dict(tgt_label=mk(B, t, SIZE, SIZE, 1), tgt_image=np.tanh(mk(B, t, SIZE, SIZE, 3)),
                 ref_labels=mk(B, 1, SIZE, SIZE, 1),
                 ref_images=np.tanh(mk(B, 1, SIZE, SIZE, 3)))
            for _ in range(n)]


def stub_teacher(cfg, seq, epoch):
    """Flows and confidences as a fixed function of the images (numpy for
    the JAX trainer, tensors for the port's); the prev flow from the
    temporal phase on, as the FlowNet2 teacher gives it."""
    img = seq["tgt_image"]
    pos = img[..., :1] > 0
    flow, conf = 3 * img[..., :2], pos.float() if torch.is_tensor(pos) else pos.astype(np.float32)
    temporal = epoch > cfg.niter_single
    return [flow, 2 * flow if temporal else None], [conf, conf if temporal else None]


@dataclasses.dataclass
class Shared:
    jcfg: object
    tcfg: object
    jmodels: object
    jstate0: object


def jax_state(jcfg, jmodels, rng):
    """A JAX train state with every variable drawn from numpy."""
    z = lambda *s: jnp.zeros(s, jnp.float32)
    batch = dict(tgt_label=z(B, SIZE, SIZE, 1), tgt_image=z(B, SIZE, SIZE, 3),
                 ref_labels=z(B, 1, SIZE, SIZE, 1), ref_images=z(B, 1, SIZE, SIZE, 3))
    st = jax.eval_shape(lambda: jstate.init_state(jcfg, jmodels, jax.random.PRNGKey(0),
                                                  batch))

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


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    # the trainers' own fields are set here too: the config is a static
    # argument of the JAX step, so one config means one compile
    kw = tiny(pool_size=3, lr=LR, print_freq=B, display_freq=0, save_latest_freq=0,
              niter_single=1, checkpoints_dir=str(tmp_path_factory.mktemp("ckpt")))
    jcfg = jax_face_config(compute_dtype="float32", **kw)
    tcfg = tconfig.face_config(compute_dtype="float32", **kw)
    jmodels = jstate.build_models(jcfg)
    return Shared(jcfg, tcfg, jmodels, jax_state(jcfg, jmodels, np.random.RandomState(5)))


def port_models(tcfg, st):
    models = tstate.build_models(tcfg, device="cpu")
    models.netG.load_state_dict(state_dict_from_jax(
        to_numpy(dict(st.aux_G["G"], params=st.params_G["G"])), tcfg), strict=True)
    for net, key in ((models.netD, "D"), (models.netDT, "DT")):
        net.load_state_dict(discriminator_state_dict_from_jax(
            to_numpy(dict(st.aux_D[key], params=st.params_D[key]))), strict=True)
    models.vgg.load_state_dict(vgg_state_dict_from_jax(to_numpy(st.vgg_params)),
                               strict=True)
    return models


def assert_losses(got, want, rtol=LOSS_RTOL):
    assert set(got) == set(want)
    for key in sorted(want):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=rtol,
                                   atol=1e-6, err_msg=key)
    for key in ("G_GAN", "G_VGG", "F_Flow", "F_Warp", "D_real", "D_fake"):
        assert float(got[key]) > 0, key


# ----------------------------------------------------------------------
def test_n_frames_total_for_epoch_equals_jax():
    for kw in (dict(), dict(niter_single=3, niter_step=2),
               dict(niter_single=0, niter_step=5, n_frames_total=4)):
        jcfg, tcfg = jax_face_config(**kw), tconfig.face_config(**kw)
        got = [ttrainer.n_frames_total_for_epoch(tcfg, e) for e in range(1, 41)]
        assert got == [jtrainer.n_frames_total_for_epoch(jcfg, e) for e in range(1, 41)]
        assert got[0] == (1 if jcfg.niter_single else jcfg.n_frames_total)
        assert max(got) <= 30


def test_copy_temporal_params_equals_jax():
    """With a separate temporal flow network (sep_flow_prev) and a separate
    previous-frame embedding, the port copies the reference branch's
    parameters into them in place, as the JAX function copies its params
    (buffers keep their own values); the optimizer holds the same tensors."""
    kw = tiny(sep_flow_prev=True)
    jcfg, tcfg = jax_face_config(compute_dtype="float32", **kw), tconfig.face_config(**kw)
    assert not jcfg.flow_temp_is_shared and not jcfg.prev_embedding_is_shared
    jmodels = jstate.build_models(jcfg)
    rng = np.random.RandomState(2)
    z = lambda *s: jnp.zeros(s, jnp.float32)
    shapes = jax.eval_shape(lambda: jmodels.netG.init(
        jax.random.PRNGKey(0), z(B, SIZE, SIZE, 1), z(B, 1, SIZE, SIZE, 1),
        z(B, 1, SIZE, SIZE, 3), z(B, SIZE, SIZE, 1), z(B, SIZE, SIZE, 3),
        warp_prev=True, train=True))
    variables = random_uv(randomize(shapes, rng), rng)

    @dataclasses.dataclass
    class ParamsOnly:   # what the JAX function reads and replaces
        params_G: dict

        def replace(self, **kw):
            return dataclasses.replace(self, **kw)

    copied = jtrainer.copy_temporal_params(
        jcfg, ParamsOnly({"G": variables["params"]})).params_G["G"]
    want = state_dict_from_jax(to_numpy(dict(variables, params=copied)), tcfg)

    models = tstate.build_models(tcfg, device="cpu")
    models.netG.load_state_dict(state_dict_from_jax(to_numpy(variables), tcfg), strict=True)
    state = tstate.TrainState(tcfg, models)
    held = [p for g in state.opt_G.param_groups for p in g["params"]]
    before = {n: p.detach().clone() for n, p in models.netG.named_parameters()}
    ttrainer.copy_temporal_params(tcfg, models)
    got = models.netG.state_dict()
    assert set(got) == set(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=key)
    changed = {n for n, p in models.netG.named_parameters() if not torch.equal(p, before[n])}
    assert changed and all(n.startswith(("flow_network_temp.", "img_prev_embedding."))
                           for n in changed)
    assert all(a is b for a, b in zip(held, models.netG.parameters()))


def pool_batch(shared, mask, seed=4):
    """One frame as the trainer builds it with the pool on."""
    seq = sequences(seed, 1, 1)[0]
    (flow, _), (conf, _) = stub_teacher(shared.jcfg, seq, 1)
    rng = np.random.RandomState(seed + 1)
    return dict(tgt_label=seq["tgt_label"][:, 0], tgt_image=seq["tgt_image"][:, 0],
                ref_labels=seq["ref_labels"], ref_images=seq["ref_images"],
                flow_gt=[flow[:, 0], None], conf_gt=[conf[:, 0], None],
                pool_fake=np.tanh(rng.randn(B, SIZE, SIZE, 3)).astype(np.float32),
                pool_mask=np.full((B, 1, 1, 1), mask))


@pytest.mark.parametrize("mask", [True, False])
def test_pool_step_equals_jax(shared, mask):
    """D sees the pool's stored fake where pool_mask is set (the JAX step's
    per-sample swap, step.py:343-347); G's losses do not change."""
    batch = pool_batch(shared, mask)
    flags = dict(warp_prev=False, has_prev=False, use_pool=True)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    _, _, want, _ = jstep.train_step(shared.jcfg, shared.jmodels, shared.jstate0, jbatch,
                                     jstep.init_prevs(shared.jcfg, jbatch),
                                     jstep.StepFlags(**flags), jax.random.PRNGKey(1))
    tbatch = {k: [None if x is None else torch.from_numpy(x) for x in v]
              if isinstance(v, list) else torch.from_numpy(v) for k, v in batch.items()}
    runs = {}
    for use_pool in (True, False):
        state = tstate.TrainState(shared.tcfg, port_models(shared.tcfg, shared.jstate0))
        _, runs[use_pool], _ = tstep.train_step(
            shared.tcfg, state, tbatch, tstep.init_prevs(shared.tcfg, tbatch),
            tstep.StepFlags(**dict(flags, use_pool=use_pool)), compute_dtype="float32")
    assert_losses(runs[True], jax.device_get(want))
    same = float(runs[True]["D_fake"]) == float(runs[False]["D_fake"])
    assert same != mask


def test_trainer_first_iteration_equals_jax(shared, tmp_path):
    """One epoch of 2 iterations with the pool on, from the same init: the
    losses each trainer logs after its first iteration."""
    seqs = sequences(7, 2, 1)

    class Errors:   # the visualizer calls the trainers make when they log
        def __init__(self):
            self.logged = []

        def print_current_errors(self, epoch, i, errors, t):
            self.logged.append(dict(errors))

        def plot_current_errors(self, errors, step):
            pass

    jcfg = shared.jcfg   # unchanged: the pool test compiled the step for it
    tcfg = shared.tcfg.replace(name="port")
    jvis, tvis = Errors(), Errors()
    jt = jtrainer.Trainer(jcfg, models=shared.jmodels, log_fn=lambda m: None,
                          visualizer=jvis)
    assert jt.mesh is None
    jt.state = shared.jstate0
    jt.train_epoch(1, seqs, stub_teacher)
    tt = ttrainer.Trainer(tcfg, models=port_models(tcfg, shared.jstate0),
                          log_fn=lambda m: None, visualizer=tvis, device="cpu")
    tt.setup()
    tt.train_epoch(1, seqs, stub_teacher)
    assert len(tvis.logged) == len(jvis.logged) == 2
    assert_losses(tvis.logged[0], jvis.logged[0])
    assert tt.state.step == 2 and tt.pool.num_imgs == 2


def test_trainer_epoch_equals_the_step_run_by_hand(shared, tmp_path):
    """A temporal epoch (2 sequences of 3 frames, teacher flows for both
    branches, the pool off) through the trainer against the port's
    train_step driven by hand over the same batches: bitwise."""
    tcfg = shared.tcfg.replace(checkpoints_dir=str(tmp_path), pool_size=0,
                               niter_single=0, print_freq=0, display_freq=0,
                               save_latest_freq=0)
    seqs = sequences(9, 2, 3)
    models = [port_models(tcfg, shared.jstate0) for _ in range(2)]
    tt = ttrainer.Trainer(tcfg, models=models[0], log_fn=lambda m: None, device="cpu")
    tt.setup()
    metrics = tt.train_epoch(1, seqs, stub_teacher)

    state = tstate.TrainState(tcfg, models[1])
    tstate.set_epoch_lr(tcfg, state, 1)
    ttrainer.copy_temporal_params(tcfg, models[1])
    sums = {}
    for seq in seqs:
        seq = {k: torch.from_numpy(v) for k, v in seq.items()}
        flow, conf = stub_teacher(tcfg, seq, 1)
        prevs, seq_losses = None, {}
        for t in range(3):
            batch = dict(tgt_label=seq["tgt_label"][:, t], tgt_image=seq["tgt_image"][:, t],
                         ref_labels=seq["ref_labels"], ref_images=seq["ref_images"],
                         flow_gt=[f[:, t] for f in flow], conf_gt=[c[:, t] for c in conf])
            prevs = tstep.init_prevs(tcfg, batch) if prevs is None else prevs
            prevs, losses, _ = tstep.train_step(
                tcfg, state, batch, prevs, tstep.StepFlags(True, t > 0), "float32")
            for k, v in losses.items():
                seq_losses[k] = seq_losses.get(k, 0) + v
        for k, v in seq_losses.items():
            sums[k] = sums.get(k, 0.0) + float(v / 3)
    for (name, a), b in zip(models[0].netG.state_dict().items(),
                            models[1].netG.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(tt.state.opt_D.state.values(), state.opt_D.state.values()):
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    assert metrics.keys() == sums.keys()
    for k in sums:
        assert metrics[k] == pytest.approx(sums[k] / 2, rel=1e-6, abs=1e-7), k
    assert metrics["F_Flow"] > 0 and tt.state.step == 6
