"""The port's VAE bottleneck (lambda_kld > 0, `_compute_kld`) and its
reference labels concatenated to the reference images
(use_label_ref='concat'), both on, against the JAX package's, on the CPU in
f32 at a tiny face configuration (ngf 4, 32 px, three downsamplings, two
adaptive layers, batch 2):

  * the layers the JAX init creates, carried by `state_dict_from_jax`
    (fc_kld as the reference's `fc`) and back by the JAX package's
    `import_fewshot_generator` unchanged;
  * the eval forward (z = mu) at K = 1 and K = 2: frames 1e-4, mu 1e-4;
  * the train forward with the VAE's noise eps drawn by numpy, given to
    the port as `vae_eps` and to JAX by patching `jax.random.normal` around
    the apply: frames, mu, logvar and the mutated batch statistics and
    spectral vectors, 1e-4;
  * `kld_loss`, 1e-6 relative;
  * step 1 of `train_step` and of `train_step_faithful` from one shared
    state with the same eps (batch `vae_eps`; the faithful step reuses it in
    both generations, as JAX reuses its rng): every loss, G_KLD included,
    1e-4 relative (tests/test_torch_train_step.py's tolerance), in
    tests/test_torch_kld_concat_step.py and test_torch_kld_concat_faithful.py
    (`check_step_one`);
  * use_label_ref='concat,mul' fails in the JAX package and the port
    refuses it by that failure;
  * the serving export of this configuration at K = 2 (z = mu; the
    attention is the registered operator) against the pipeline, 1e-5, and
    the export's refusal of refine_face, which the JAX export lacks.
"""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from fsvid2vid_tpu.config import face_config as jface
from fsvid2vid_tpu.losses.gan import kld_loss as jax_kld_loss
from fsvid2vid_tpu.models.generator import FewShotGenerator as JaxGenerator
from fsvid2vid_tpu.training import step as jstep
from fsvid2vid_tpu.utils.torch_port import import_fewshot_generator
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.inference.pipeline import InferencePipeline
from fsvid2vid_tpu_torch.inference.serve import export_serving, load_serving
from fsvid2vid_tpu_torch.losses.gan import kld_loss
from fsvid2vid_tpu_torch.models import build_generator
from fsvid2vid_tpu_torch.models.generator import FewShotGenerator
from fsvid2vid_tpu_torch.training import step as tstep
from fsvid2vid_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_layers import randomize, to_numpy
from tests.test_torch_train_step import port_state, tbatch

ATOL = 1e-4
LOSS_RTOL = 1e-4
SERVE_ATOL = 1e-5
B, SIZE = 2, 32
OPTIONS = dict(lambda_kld=1.0, use_label_ref="concat")
TINY = dict(ngf=4, nff=4, ndf=4, fine_size=SIZE, load_size=SIZE, n_blocks_F=2,
            n_downsample_G=3, n_adaptive_layers=2, **OPTIONS)


def configs(k, **kw):
    jcfg = jface(**dict(TINY, n_shot=k, compute_dtype="float32", **dict(dict(batch_size=B), **kw)))
    return jcfg, tconfig.Config.from_json(jcfg.to_json())


def inputs(rng, k, b=B):
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    return (mk(b, SIZE, SIZE, 1), mk(b, k, SIZE, SIZE, 1),
            np.tanh(mk(b, k, SIZE, SIZE, 3)), mk(b, SIZE, SIZE, 1),
            np.tanh(mk(b, SIZE, SIZE, 3)))


@contextlib.contextmanager
def jax_normal_returns(eps):
    """jax.random.normal giving `eps` for draws of its shape (B, 256), the
    VAE's noise, and drawing as before for any other shape."""
    normal = jax.random.normal

    def patched(key, shape=(), *a, **kw):
        if tuple(shape) == eps.shape:
            return jnp.asarray(eps)
        return normal(key, shape, *a, **kw)
    with mock.patch.object(jax.random, "normal", patched):
        yield


@pytest.fixture(scope="module", params=[1, 2], ids=["k1", "k2"])
def generators(request):
    """The JAX generator's variables (shaped by its train-mode init, which
    creates fc_var_ref too) redrawn from numpy, and the port's."""
    k = request.param
    rng = np.random.RandomState(20 + k)
    jcfg, tcfg = configs(k)
    jm = JaxGenerator(jcfg)
    args = [jnp.asarray(a) for a in inputs(rng, k)]
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "vae": jax.random.PRNGKey(1)},
                                            *args, warp_prev=True, train=True))
    v = randomize(shapes, rng)
    g = build_generator(tcfg, device="cpu")
    g.load_state_dict(state_dict_from_jax(to_numpy(v), tcfg), strict=True)
    return k, jcfg, tcfg, jm, v, g


def port_inputs(arrays):
    return [torch.from_numpy(a).movedim(-1, -3) for a in arrays]


def test_layers_follow_the_jax_init(generators):
    k, jcfg, tcfg, jm, v, g = generators
    f_dim = 32 * 4 * 4                      # min(1024, ngf 2^3) x (32 / 2^3)^2
    assert tuple(g.fc_mu_ref.weight.shape) == tuple(g.fc_var_ref.weight.shape) == (256, f_dim)
    assert tuple(g.fc.weight.shape) == (f_dim, 256)
    assert g.ref_img_first.conv.weight_orig.shape[1] == 3 + 1   # image + label
    assert not hasattr(g, "ref_label_first")
    assert g.fc_spade_0_0[0].weight_orig.shape[1] == 32 * 32    # the pooled map
    # the VAE's fc_kld is the reference's `fc`, both ways through the converters
    sd = state_dict_from_jax(to_numpy(v), tcfg)
    np.testing.assert_array_equal(sd["fc.weight"].numpy(), np.asarray(v["params"]["fc_kld"]["kernel"]).T)
    back = flatten_dict(import_fewshot_generator(v, sd, tcfg))
    for path, x in flatten_dict(to_numpy(v)).items():
        np.testing.assert_array_equal(back[path], x, err_msg=str(path))


@pytest.mark.parametrize("prev", [False, True], ids=["first", "warp_prev"])
def test_eval_forward_matches_jax(generators, prev):
    k, jcfg, tcfg, jm, v, g = generators
    arrays = inputs(np.random.RandomState(30 + k), k)
    if not prev:
        arrays = arrays[:3]
    want = jm.apply(v, *map(jnp.asarray, arrays), warp_prev=prev, train=False)
    out = g.eval()(*port_inputs(arrays), warp_prev=prev)
    assert out["logvar"] is None and want["logvar"] is None
    img = np.asarray(want["img_final"])
    assert img.std() > 0.05
    np.testing.assert_allclose(out["img_final"].detach().movedim(1, -1).numpy(), img, atol=ATOL)
    np.testing.assert_allclose(out["mu"].detach().numpy(), np.asarray(want["mu"]), atol=ATOL)
    if k > 1:
        assert out["ref_idx"].tolist() == np.asarray(want["ref_idx"]).tolist()


def test_train_forward_with_injected_eps_matches_jax(generators):
    k, jcfg, tcfg, jm, v, g = generators
    rng = np.random.RandomState(40 + k)
    arrays = inputs(rng, k)
    eps = rng.randn(B, 256).astype(np.float32)
    with jax_normal_returns(eps):
        want, mutated = jm.apply(v, *map(jnp.asarray, arrays), warp_prev=True, train=True,
                                 mutable=["spectral", "batch_stats"],
                                 rngs={"vae": jax.random.PRNGKey(2)})
    g.train()
    out = g(*port_inputs(arrays), warp_prev=True, vae_eps=torch.from_numpy(eps))
    for key in ("mu", "logvar"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(want[key]),
                                   atol=ATOL, err_msg=key)
    np.testing.assert_allclose(out["img_final"].detach().movedim(1, -1).numpy(),
                               np.asarray(want["img_final"]), atol=ATOL)
    after = state_dict_from_jax(to_numpy(dict(v, **mutated)), tcfg)
    for name, t in g.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(t.numpy(), after[name].numpy(), atol=ATOL, err_msg=name)
    # another eps, another z
    out2 = g(*port_inputs(arrays), warp_prev=True, vae_eps=torch.from_numpy(-eps))
    assert not torch.allclose(out2["img_final"], out["img_final"])
    with pytest.raises(ValueError, match="vae_eps"):
        g(*port_inputs(arrays), warp_prev=True)


def test_kld_loss_matches_jax():
    rng = np.random.RandomState(5)
    mu, logvar = rng.randn(2, 3, 256).astype(np.float32)
    want = float(jax_kld_loss(jnp.asarray(mu), jnp.asarray(logvar)))
    got = kld_loss(torch.from_numpy(mu), torch.from_numpy(logvar))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert float(kld_loss(torch.zeros(2, 256), torch.zeros(2, 256))) == 0.0


def check_step_one(shared, name):
    """Step 1 of `name` ("train_step" or "train_step_faithful") from the
    shared state with the same eps, against JAX; each step is checked in a
    file of its own (tests/test_torch_kld_concat_step.py,
    tests/test_torch_kld_concat_faithful.py), so that the two JAX step
    compiles, the longest of this configuration, run on separate workers."""
    eps = np.random.RandomState(6).randn(B, 256).astype(np.float32)
    jbatch = jax.tree_util.tree_map(jnp.asarray, shared.batch)
    flags = (False, False)
    with jax_normal_returns(eps):
        _, _, want, _ = getattr(jstep, name)(
            shared.jcfg, shared.jmodels, shared.jstate0, jbatch,
            jstep.init_prevs(shared.jcfg, jbatch), jstep.StepFlags(*flags),
            jax.random.PRNGKey(1))
    state = port_state(shared)
    batch = dict(tbatch(shared.batch), vae_eps=torch.from_numpy(eps))
    _, got, _ = getattr(tstep, name)(shared.tcfg, state, batch,
                                     tstep.init_prevs(shared.tcfg, batch),
                                     tstep.StepFlags(*flags))
    want = jax.device_get(want)
    assert "G_KLD" in want and set(got) == set(want)
    for key in sorted(want):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=key)
    assert float(got["G_KLD"]) > 0
    # a batch without the noise is refused; with_vae_noise draws it from a
    # CPU generator, the same for the same seed
    with pytest.raises(ValueError, match="vae_eps"):
        getattr(tstep, name)(shared.tcfg, state, tbatch(shared.batch),
                             tstep.init_prevs(shared.tcfg, batch), tstep.StepFlags())
    draws = [tstep.with_vae_noise(shared.tcfg, tbatch(shared.batch),
                                  torch.Generator().manual_seed(3))["vae_eps"]
             for _ in range(2)]
    assert draws[0].shape == (B, 256) and torch.equal(draws[0], draws[1])
    assert "vae_eps" not in tstep.with_vae_noise(shared.tcfg.replace(lambda_kld=0.0),
                                                 tbatch(shared.batch), None)


def test_concat_mul_fails_in_jax_and_is_refused():
    jcfg, tcfg = configs(1, use_label_ref="concat,mul")
    args = [jnp.asarray(a) for a in inputs(np.random.RandomState(0), 1)]
    with pytest.raises(AttributeError, match="'NoneType' object has no attribute 'shape'"):
        jax.eval_shape(lambda: JaxGenerator(jcfg).init(
            {"params": jax.random.PRNGKey(0), "vae": jax.random.PRNGKey(1)}, *args,
            warp_prev=True, train=True))
    with pytest.raises(NotImplementedError, match="'concat,mul'.*NoneType.*ROADMAP.md C"):
        FewShotGenerator(tcfg)


def test_serving_export_matches_the_pipeline(tmp_path):
    """K = 2 with the VAE and concat: the saved programs' frames against
    InferencePipeline's (both f32 on the CPU); refine_face is refused."""
    rng = np.random.RandomState(7)
    _, tcfg = configs(2, batch_size=1, is_train=False, init_variance=1.0)
    g = build_generator(tcfg, device="cpu", generator=torch.Generator().manual_seed(8))
    label0, ref_labels, ref_images = (a[:1] for a in inputs(rng, 2)[:3])
    labels = [label0] + [label0 + 0.1 * rng.randn(*label0.shape).astype(np.float32)
                         for _ in range(2)]
    pipe = InferencePipeline(tcfg, g)
    pipe.reset(ref_labels, ref_images, labels[0])
    want = [pipe.step(lbl)["fake_image"].numpy() for lbl in labels]
    export_serving(tcfg, g, str(tmp_path / "serve"), dtype=torch.float32)
    session = load_serving(str(tmp_path / "serve"), device="cpu")
    session.reset(ref_labels, ref_images, labels[0])
    for t, lbl in enumerate(labels):
        frame = session.step(lbl).numpy()
        np.testing.assert_allclose(frame, want[t], atol=SERVE_ATOL, err_msg=f"frame {t}")
    assert np.std(want) > 0.05
    pose = tconfig.pose_config(**dict(TINY, batch_size=1, is_train=False, refine_face=True,
                                      use_label_ref="mul", lambda_kld=0.0))
    with pytest.raises(NotImplementedError, match="JAX export"):
        export_serving(pose, build_generator(pose, device="cpu"), str(tmp_path / "pose"))
