"""The port's adaptive discriminator (netD_subarch 'adaptive') and
`adaptive_avg_pool` against the JAX package's, on the CPU in f32.

  * `adaptive_avg_pool` on maps that divide (8 -> 4), that do not (17 -> 4,
    129 -> 32, 5 x 9 -> 3 x 4) and that are smaller than the output (3 ->
    4, where torch's buckets overlap): 1e-6 (means of a few f32 numbers);
  * `MultiscaleDiscriminator(subarch='adaptive')` at num_D 1 and 2 and
    adaptive_D_layers 1 and 2, variables drawn with numpy (u / v the
    kernels' singular vectors, so that activations are of order one) and
    carried by `discriminator_state_dict_from_jax` (strictly): every
    intermediate feature at eval and in train mode, 1e-5 (the same f32
    arithmetic in another order), and the spectral u / v after the
    train-mode forward, 1e-5; with random unit u / v, which a power
    iteration moves, the u / v after it, 1e-5;
  * the parameter names round trip through the JAX package's
    `import_discriminator` unchanged, and equal the JAX init's;
  * `discriminate` with the reference as D's second input (the adaptive
    D's `concat_ref_for_D` is false) against the JAX collector, for D's
    and for G's losses: 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from fsvid2vid_tpu.config import face_config as jface
from fsvid2vid_tpu.losses import collector as jlc
from fsvid2vid_tpu.models.discriminator import MultiscaleDiscriminator as JaxMultiscaleD
from fsvid2vid_tpu.ops.image_ops import adaptive_avg_pool as jax_adaptive_avg_pool
from fsvid2vid_tpu.utils.torch_port import import_discriminator
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.losses import collector as tlc
from fsvid2vid_tpu_torch.models.discriminator import (
    MultiscaleDiscriminator, adaptive_ref_pool)
from fsvid2vid_tpu_torch.ops import adaptive_avg_pool
from fsvid2vid_tpu_torch.utils.convert import discriminator_state_dict_from_jax
from tests.test_torch_data import few_threads  # noqa: F401 (autouse)
from tests.test_torch_discriminator import nchw, nhwc
from tests.test_torch_layers import randomize, to_numpy
from tests.test_torch_train_layers import random_uv

POOL_ATOL = 1e-6
FEAT_ATOL = 1e-5
UV_ATOL = 1e-5
LOSS_RTOL = 1e-5
NDF, N_LAYERS, SIZE, B = 8, 3, 32, 2
INPUT_NC = 4      # the face D's label + image, without the reference's


@pytest.mark.parametrize("hw,out", [((8, 8), (4, 4)), ((17, 17), (4, 4)),
                                    ((129, 129), (32, 32)), ((5, 9), (3, 4)),
                                    ((3, 3), (4, 4))],
                         ids=["even", "17to4", "129to32", "5x9to3x4", "3to4"])
def test_adaptive_avg_pool_matches_jax(hw, out):
    x = np.random.RandomState(sum(hw)).randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jax_adaptive_avg_pool(jnp.asarray(x), out))
    got = nhwc(adaptive_avg_pool(nchw(x), out))
    assert got.shape == want.shape == (2, *out, 3)
    np.testing.assert_allclose(got, want, atol=POOL_ATOL)


def jax_cfg(adaptive_layers):
    return jface(ngf=4, ndf=NDF, fine_size=SIZE, load_size=SIZE, n_layers_D=N_LAYERS,
                 netD_subarch="adaptive", adaptive_D_layers=adaptive_layers,
                 compute_dtype="float32")


def make_pair(rng, num_D, adaptive_layers, x, ref, unit_uv=False):
    """(JAX module, its variables, the port's module); u / v the kernels'
    singular vectors, or random unit vectors with `unit_uv`."""
    cfg = jax_cfg(adaptive_layers)
    jd = JaxMultiscaleD(cfg, INPUT_NC, NDF, N_LAYERS, "spectralinstance", "adaptive", num_D)
    shapes = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0), x, ref, train=True))
    variables = randomize(shapes, rng)
    if unit_uv:
        variables = random_uv(variables, rng)
    td = MultiscaleDiscriminator(INPUT_NC, NDF, N_LAYERS, "spectralinstance", "adaptive",
                                 num_D, adaptive_layers=adaptive_layers,
                                 ref_pool=adaptive_ref_pool(SIZE, cfg.aspect_ratio))
    td.load_state_dict(discriminator_state_dict_from_jax(to_numpy(variables)), strict=True)
    return jd, variables, td


CASES = [(1, 1), (2, 1), (1, 2), (2, 2)]
IDS = [f"num_D{n}_layers{a}" for n, a in CASES]


@pytest.mark.parametrize("num_D,adaptive_layers", CASES, ids=IDS)
def test_features_match_jax(rng, num_D, adaptive_layers):
    x, ref = (rng.randn(B, SIZE, SIZE, INPUT_NC).astype(np.float32) for _ in range(2))
    jd, variables, td = make_pair(rng, num_D, adaptive_layers, jnp.asarray(x), jnp.asarray(ref))
    want_eval = jd.apply(variables, jnp.asarray(x), jnp.asarray(ref), train=False)
    want_train, mutated = jd.apply(variables, jnp.asarray(x), jnp.asarray(ref), train=True,
                                   mutable=["spectral"])
    with torch.no_grad():
        got_eval = td.eval()(nchw(x), nchw(ref))
        got_train = td.train()(nchw(x), nchw(ref))
    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        assert len(got) == len(want) == num_D
        for scale_got, scale_want in zip(got, want):
            assert len(scale_got) == len(scale_want) == N_LAYERS + 2
            for g, w in zip(scale_got, scale_want):
                np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=FEAT_ATOL)
    assert got_eval[0][-1].shape[1] == 1
    after = discriminator_state_dict_from_jax(
        dict(params=to_numpy(variables["params"]), spectral=to_numpy(mutated["spectral"])))
    for key, value in td.state_dict().items():
        np.testing.assert_allclose(value.numpy(), after[key].numpy(), atol=UV_ATOL, err_msg=key)


@pytest.mark.parametrize("num_D", [1, 2])
def test_train_forward_advances_u_v_like_jax(rng, num_D):
    x, ref = (rng.randn(B, SIZE, SIZE, INPUT_NC).astype(np.float32) for _ in range(2))
    jd, variables, td = make_pair(rng, num_D, 1, jnp.asarray(x), jnp.asarray(ref), unit_uv=True)
    _, mutated = jd.apply(variables, jnp.asarray(x), jnp.asarray(ref), train=True,
                          mutable=["spectral"])
    before = {k: v.clone() for k, v in td.state_dict().items()}
    with torch.no_grad():
        td.train()(nchw(x), nchw(ref))
    after = discriminator_state_dict_from_jax(
        dict(params=to_numpy(variables["params"]), spectral=to_numpy(mutated["spectral"])))
    moved = 0
    for key, value in td.state_dict().items():
        np.testing.assert_allclose(value.numpy(), after[key].numpy(), atol=UV_ATOL, err_msg=key)
        if key.endswith(("weight_u", "weight_v")):
            moved += int((value - before[key]).abs().max() > 1e-2)
    # u and v of model1..model3, and v of the spectral logit conv (its u
    # has one element, a unit vector that cannot move)
    assert moved == (2 * N_LAYERS + 1) * num_D


def test_names_round_trip_through_import_discriminator(rng):
    """The port's parameter and buffer names are the JAX init's under the
    JAX importer: every variable comes back unchanged, and the adaptive
    layers' generators are `encoder_<n>` / `fc_<n>` with no model0."""
    x = jnp.asarray(rng.randn(B, SIZE, SIZE, INPUT_NC).astype(np.float32))
    jd, variables, td = make_pair(rng, 2, 2, x, x)
    sd = td.state_dict()
    back = flatten_dict(import_discriminator(to_numpy(variables), sd))
    want = flatten_dict(to_numpy(variables))
    assert set(back) == set(want)
    for path, value in want.items():
        np.testing.assert_array_equal(back[path], value, err_msg=str(path))
    names = {k.split(".")[1] for k in sd}
    assert {"encoder_0", "fc_0", "encoder_1", "fc_1", "model2", "model4"} <= names
    assert "model0" not in names and "model1" not in names
    # the pooled reference is (fine_size / 8)^2 wide at every scale
    assert tuple(td.discriminator_1.fc_0.weight.shape) == (INPUT_NC * 16, (SIZE // 8) ** 2)


@pytest.mark.parametrize("for_discriminator", [True, False], ids=["D", "G"])
def test_discriminate_with_a_separate_reference_matches_jax(rng, for_discriminator):
    jcfg = jax_cfg(1)
    tcfg = tconfig.Config.from_json(jcfg.to_json())
    assert not jcfg.concat_ref_for_D and not tcfg.concat_ref_for_D
    assert tcfg.netD_input_nc == INPUT_NC
    mk = lambda c: rng.randn(B, SIZE, SIZE, c).astype(np.float32)
    label, fake, real, ref = mk(1), np.tanh(mk(3)), np.tanh(mk(3)), mk(INPUT_NC)
    jd, variables, td = make_pair(rng, 2, 1, jnp.asarray(mk(INPUT_NC)), jnp.asarray(ref))
    # the hinge's kinks: push most logits into its linear range
    last = f"model{N_LAYERS + 1}_conv"
    for disc in variables["params"].values():
        disc[last]["bias"] = disc[last]["bias"] + 1.0
    td.load_state_dict(discriminator_state_dict_from_jax(to_numpy(variables)), strict=True)

    def jax_apply(x, r):
        return jd.apply(variables, x, r, train=False)
    want = jlc.discriminate(jcfg, jax_apply, jnp.asarray(label), jnp.asarray(fake),
                            jnp.asarray(real), jnp.asarray(ref), for_discriminator)
    seen = []

    def port_apply(x, r=None):
        seen.append((x.shape[1], None if r is None else r.shape[1]))
        return td.eval()(x, r)
    with torch.no_grad():
        got = tlc.discriminate(tcfg, port_apply, nchw(label), nchw(fake), nchw(real),
                               nchw(ref), for_discriminator)
    assert seen == [(INPUT_NC, INPUT_NC)]     # D's input and the reference apart
    for g, w in zip(got, want):
        assert float(w) != 0
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL)
