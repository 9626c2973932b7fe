"""The port's train steps at K = 3 references against the JAX package's, on
the CPU in f32: the generator in train mode through the differentiable K > 1
attention (`chunked_ref_attention`, 4 query chunks on both sides), the
most-attended reference (`pick_ref` of ref_idx) feeding the masks and the
discriminator's reference input, and the flow-to-reference loss gated off
as at every K > 1 (losses/collector.py, JAX :174).

The shared initial state is tests/test_torch_train_step.py's at K = 3: ngf
4, ndf 4, 32 px, three downsamplings, two adaptive layers, batch 2, VGG loss
off (it does not depend on K, that file holds it, and it doubles the JAX
compiles), every variable redrawn from numpy with the discriminators' logits spread
past the hinge's kinks (`redrawn_state`), the teacher's flows numpy inputs
to both.  Compared, at that file's tolerances:
  * step 1 of `train_step` in the temporal phase with filled buffers, and of
    `train_step_faithful` single-frame: every key of the losses dict, 1e-4
    relative; the previous-frames buffers, 1e-4;
  * the generator's spectral u / v and batch statistics after the step,
    1e-4: advanced once per JAX apply, so once by `train_step` and twice by
    `train_step_faithful`, the attention's key encoder over the B·K
    references and its query encoder over the B targets each time;
  * ref_idx, where JAX's top two attention masses lie apart by more than
    100 times their tolerance (tests/test_torch_generator_train_k3.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fsvid2vid_tpu.config import face_config as jax_face_config
from fsvid2vid_tpu.models.generator import FewShotGenerator as JaxGenerator
from fsvid2vid_tpu.models.vgg import Vgg19Features
from fsvid2vid_tpu.training import state as jstate
from fsvid2vid_tpu.training import step as jstep
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.training import state as tstate
from fsvid2vid_tpu_torch.training import step as tstep
from fsvid2vid_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax, state_dict_from_jax)
from tests.test_torch_data import few_threads  # noqa: F401 (autouse)
from tests.test_torch_layers import to_numpy
from tests.test_torch_street_step import redrawn_state
from tests.test_torch_train_step import (
    LOSS_RTOL_STEP1, PREVS_ATOL, assert_prevs, tbatch, tiny)

K, B, SIZE = 3, 2, 32
HW = (SIZE // 4) ** 2            # the attention's map, n_downsample_A = 2
CHUNK_ELEMS = K * HW * HW // 4   # 4 query chunks
CFG = dict(n_shot=K, no_vgg_loss=True)   # VGG19 is K-independent and
# tests/test_torch_train_step.py holds it; leaving it out halves the compiles
STATE_ATOL = 1e-4
MASS_ATOL = HW * 1e-5


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
    rng = np.random.RandomState(6)
    jcfg = jax_face_config(**tiny(compute_dtype="float32", **CFG))
    tcfg = tconfig.face_config(**tiny(**CFG))
    h = w = SIZE
    cl = jcfg.gen_input_nc
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    conf = lambda: (rng.rand(B, h, w, 1) > 0.3).astype(np.float32)
    batch = dict(tgt_label=mk(B, h, w, cl), tgt_image=np.tanh(mk(B, h, w, 3)),
                 ref_labels=mk(B, K, h, w, cl), ref_images=np.tanh(mk(B, K, h, w, 3)),
                 flow_gt=[2 * mk(B, h, w, 2), 2 * mk(B, h, w, 2)],
                 conf_gt=[conf(), conf()])
    prevs = dict(label=mk(B, h, w, cl), real=np.tanh(mk(B, h, w, 3)),
                 fake=np.tanh(mk(B, h, w, 3)))
    jmodels = dataclasses.replace(jstate.build_models(jcfg),
                                  netG=JaxGenerator(jcfg, atn_chunk_elems=CHUNK_ELEMS))
    # shaped and drawn as that file's state, VGG19's variables included
    st = redrawn_state(jcfg, dataclasses.replace(jmodels, vgg=Vgg19Features()),
                       jax.tree_util.tree_map(jnp.asarray, batch), rng)
    return Shared(jcfg, tcfg, jmodels, st.replace(vgg_params=None), batch, prevs)


def port_models(tcfg, st):
    models = tstate.build_models(tcfg, device="cpu")
    assert models.vgg is None
    models.netG.load_state_dict(state_dict_from_jax(
        to_numpy(dict(st.aux_G["G"], params=st.params_G["G"])), tcfg), strict=True)
    for key in st.params_D:
        getattr(models, "net" + key).load_state_dict(discriminator_state_dict_from_jax(
            to_numpy(dict(st.aux_D[key], params=st.params_D[key]))), strict=True)
    return models


def run_jax(shared, step_fn, flags, prevs):
    jbatch = jax.tree_util.tree_map(jnp.asarray, shared.batch)
    pv = (jstep.init_prevs(shared.jcfg, jbatch) if prevs is None
          else jax.tree_util.tree_map(jnp.asarray, prevs))
    st, pv, losses, _ = step_fn(shared.jcfg, shared.jmodels, shared.jstate0, jbatch, pv,
                                jstep.StepFlags(*flags), jax.random.PRNGKey(1))
    return st, jax.device_get(pv), jax.device_get(losses)


def run_port(shared, step_fn, flags, prevs):
    state = tstate.TrainState(shared.tcfg, port_models(shared.tcfg, shared.jstate0))
    state.models.netG.atn_chunk_elems = CHUNK_ELEMS
    batch = tbatch(shared.batch)
    pv = tstep.init_prevs(shared.tcfg, batch) if prevs is None else tbatch(prevs)
    pv, losses, visuals = step_fn(shared.tcfg, state, batch, pv, tstep.StepFlags(*flags))
    return state, pv, losses, visuals


@pytest.fixture(scope="module")
def jax_masses(shared):
    """JAX's attention masses (B, K) of the step's first generator forward."""
    s, st = shared.batch, shared.jstate0
    v = dict(st.aux_G["G"], params=st.params_G["G"])
    return np.asarray(jax.jit(lambda v, *a: shared.jmodels.netG.apply(
        v, *a, train=True, mutable=["spectral", "batch_stats"],
        method=lambda m, i, l, x, train: m.weight_generation(i, l, x, train=train)
    )[0][1]["atn"])(v, *[jnp.asarray(s[k]) for k in ("ref_images", "ref_labels",
                                                     "tgt_label")]))


@pytest.mark.parametrize("name,flags,with_prevs", [
    ("train_step", (True, True), True), ("train_step_faithful", (False, False), False)],
    ids=["train_step_temporal", "train_step_faithful"])
def test_step_one_matches_jax(shared, jax_masses, name, flags, with_prevs):
    prevs = shared.prevs if with_prevs else None
    jst, jprevs, want = run_jax(shared, getattr(jstep, name), flags, prevs)
    state, prevs_out, got, visuals = run_port(shared, getattr(tstep, name), flags, prevs)
    assert set(got) == set(want)
    for key in sorted(want):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=LOSS_RTOL_STEP1,
                                   atol=1e-6, err_msg=key)
    for key in ("G_GAN", "G_GAN_Feat", "F_Warp", "F_Mask", "D_real", "D_fake"):
        assert float(got[key]) > 0, key
    assert float(got["F_Flow"]) == 0 == float(got["G_VGG"])   # no flow loss at K > 1
    assert_prevs(prevs_out, jprevs, PREVS_ATOL)
    # every G buffer, the attention encoders' among them, as JAX's after
    # one apply (train_step) or two (train_step_faithful)
    want_G = state_dict_from_jax(to_numpy(dict(jst.aux_G["G"], params=jst.params_G["G"])),
                                 shared.tcfg)
    got_G = state.models.netG.state_dict()
    checked = []
    for key in got_G:
        if key.endswith(("weight_u", "weight_v", "running_mean", "running_var")):
            np.testing.assert_allclose(got_G[key].numpy(), want_G[key].numpy(),
                                       atol=STATE_ATOL, err_msg=f"{name} {key}")
            checked.append(key)
    assert any(k.startswith("atn_key_1.") for k in checked)
    assert any(k.startswith("atn_query_first.") for k in checked)
    # the picked reference is the most-attended one
    masses = jax_masses
    top2 = np.sort(masses, 1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 100 * MASS_ATOL).all(), top2
    pick = np.argmax(masses, 1)
    np.testing.assert_array_equal(visuals["ref_image"].numpy(),
                                  shared.batch["ref_images"][np.arange(B), pick])
