"""The port's PatchGAN discriminators against the JAX package, on the CPU.

Variables are drawn with numpy (`randomize`) and carried across by
`discriminator_state_dict_from_jax`, loaded strictly.  Tolerances: the
per-layer activations at eval 1e-4 (the same f32 arithmetic, convolution
sums in another order, on activations of order one); spectral u / v after one
train-mode forward 1e-5 (unit vectors from one matrix-vector product each).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.models.discriminator import (
    MultiscaleDiscriminator as JaxMultiscaleD)
from fsvid2vid_tpu_torch.models.discriminator import MultiscaleDiscriminator
from fsvid2vid_tpu_torch.utils.convert import discriminator_state_dict_from_jax
from tests.test_networks import tiny_face_cfg
from tests.test_torch_layers import randomize, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_ATOL = 1e-4
UV_ATOL = 1e-5
INPUT_NC, NDF, N_LAYERS = 8, 8, 3


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, -3)))


def nhwc(t):
    return t.detach().movedim(-3, -1).numpy()


def make_pair(rng, num_D, x):
    """(JAX module, its variables with random unit u / v, the port's module)."""
    jd = JaxMultiscaleD(tiny_face_cfg(), INPUT_NC, NDF, N_LAYERS,
                        "spectralinstance", "n_layers", num_D)
    shapes = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0), x, None, train=True))
    variables = randomize(shapes, rng)
    # u / v away from the singular vectors, so a power iteration moves them
    variables["spectral"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray((lambda r: r / np.linalg.norm(r))(
            rng.randn(*a.shape)).astype(np.float32)), variables["spectral"])
    td = MultiscaleDiscriminator(INPUT_NC, NDF, N_LAYERS, "spectralinstance",
                                 "n_layers", num_D)
    td.load_state_dict(discriminator_state_dict_from_jax(to_numpy(variables)),
                       strict=True)
    return jd, variables, td


@pytest.mark.parametrize("num_D", [1, 2])
def test_features_match_jax_at_eval(rng, num_D):
    x = rng.randn(2, 32, 32, INPUT_NC).astype(np.float32)
    jd, variables, td = make_pair(rng, num_D, jnp.asarray(x))
    want = jd.apply(variables, jnp.asarray(x), None, train=False)
    with torch.no_grad():
        got = td.eval()(nchw(x))
    assert len(got) == len(want) == num_D
    for scale_got, scale_want in zip(got, want):
        assert len(scale_got) == len(scale_want) == N_LAYERS + 2
        for g, w in zip(scale_got, scale_want):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=FEAT_ATOL)
    assert got[0][-1].shape[1] == 1    # the logit map


@pytest.mark.parametrize("num_D", [1, 2])
def test_train_forward_advances_u_v_like_jax(rng, num_D):
    x = rng.randn(2, 32, 32, INPUT_NC).astype(np.float32)
    jd, variables, td = make_pair(rng, num_D, jnp.asarray(x))
    want, mutated = jd.apply(variables, jnp.asarray(x), None, train=True,
                             mutable=["spectral"])
    before = {k: v.clone() for k, v in td.state_dict().items()}
    got = td.train()(nchw(x))
    for scale_got, scale_want in zip(got, want):
        for g, w in zip(scale_got, scale_want):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=FEAT_ATOL)
    new = discriminator_state_dict_from_jax(
        dict(params=to_numpy(variables["params"]),
             spectral=to_numpy(mutated["spectral"])))
    moved = 0
    for key, value in td.state_dict().items():
        np.testing.assert_allclose(value.numpy(), new[key].numpy(), atol=UV_ATOL)
        if key.endswith(("weight_u", "weight_v")):
            moved += int((value - before[key]).abs().max() > 1e-2)
    assert moved == 2 * N_LAYERS * num_D   # every u and v moved


def test_first_and_last_layers_are_plain_convs():
    sd = MultiscaleDiscriminator(INPUT_NC, NDF, N_LAYERS).state_dict()
    assert "discriminator_0.model0.0.weight" in sd
    assert f"discriminator_0.model{N_LAYERS + 1}.0.weight" in sd
    assert "discriminator_0.model1.0.0.weight_orig" in sd
    assert not any("model0" in k and "weight_u" in k for k in sd)


def test_reference_discriminator_init_loads_strictly():
    """The 24 keys of the reference's discriminator in the convergence
    study's initial checkpoint."""
    init = torch.load(os.path.join(REPO, "convergence_r4_faithful.json.init.pt"),
                      map_location="cpu", weights_only=False)["D"]
    assert len(init) == 24
    d = MultiscaleDiscriminator(input_nc=8, ndf=16, n_layers=4)
    d.load_state_dict(init, strict=True)
    out = d.eval()(torch.zeros(1, 8, 32, 32))
    assert len(out) == 1 and len(out[0]) == 6


def test_adaptive_subarchitecture_is_not_ported():
    with pytest.raises(NotImplementedError, match="adaptive"):
        MultiscaleDiscriminator(INPUT_NC, NDF, N_LAYERS, subarch="adaptive")
    d = MultiscaleDiscriminator(INPUT_NC, NDF, N_LAYERS)
    with pytest.raises(NotImplementedError, match="adaptive"):
        d(torch.zeros(1, INPUT_NC, 16, 16), ref=torch.zeros(1, INPUT_NC, 16, 16))
