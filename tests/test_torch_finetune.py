"""The port's test-time finetune against the JAX package's
(fsvid2vid_tpu/inference/finetune.py), on the CPU in f32:

  * `finetune_mask` over the port's parameter names selects the modules
    that the JAX `finetune_mask` selects over flax paths, mapped through
    `utils/convert.py::torch_key`, for tiny face, pose and street
    generators;
  * `random_roll_np` gives the JAX function's rolls and flips from the same
    seed;
  * two finetune steps of a tiny pose model (scripts/pose/test.sh passes
    --finetune; face D and remat on) from one shared state: each step's
    losses 1e-4 relative to the JAX loop's (tests/test_torch_pose_step.py's
    tolerance), at lr 1e-6 for the beta1 = 0 reason of
    tests/test_torch_trainer.py's docstring; the generator parameters the
    mask selects within 4 lr of JAX's after the two steps (two Adam steps
    of at most lr each, whose signs may differ where a gradient is ~0),
    the others bitwise unchanged on both sides.
K = 3 is held against JAX in tests/test_torch_finetune_k3.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from fsvid2vid_tpu import config as jconfig
from fsvid2vid_tpu.inference import finetune as jft
from fsvid2vid_tpu.models.generator import FewShotGenerator as JaxGenerator
from fsvid2vid_tpu.training import state as jstate
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.inference import finetune as tft
from fsvid2vid_tpu_torch.models import build_generator
from fsvid2vid_tpu_torch.utils.convert import state_dict_from_jax, torch_key
from tests.test_torch_data import few_threads  # noqa: F401 (autouse)
from tests.test_torch_layers import to_numpy
from tests.test_torch_pose_losses import pose_label
from tests.test_torch_street_step import port_models, redrawn_state, street_labels

LOSS_RTOL = 1e-4
LR = 1e-6
ITERS = 2
TINY = dict(ngf=4, nff=4, ndf=4, fine_size=32, load_size=32, n_blocks_F=2,
            n_downsample_G=3, n_adaptive_layers=2, batch_size=1)


def labels_for(cfg, rng, *lead):
    h, w = cfg.height, cfg.width
    if cfg.label_nc:
        return np.eye(cfg.label_nc, dtype=np.float32)[
            street_labels(rng, *lead, h, w)[..., 0].astype(int)]
    if cfg.is_pose:
        return pose_label(rng, int(np.prod(lead)), h, w).reshape(*lead, h, w, 6)
    return rng.randn(*lead, h, w, cfg.input_nc).astype(np.float32)


@pytest.mark.parametrize("workload", ["face", "pose", "street"])
def test_finetune_mask_selects_the_jax_modules(workload):
    """Module by module: a torch module's parameters are all selected or
    all not, and the selected modules are the images under torch_key of the
    flax modules whose parameters the JAX mask selects."""
    rng = np.random.RandomState(1)
    jcfg = jconfig.preset(workload, **TINY)
    tcfg = tconfig.Config.from_json(jcfg.to_json())
    label, ref_label = labels_for(jcfg, rng, 1), labels_for(jcfg, rng, 1, 1)
    images = np.zeros((1, 1, jcfg.height, jcfg.width, 3), np.float32)
    params = jax.eval_shape(lambda *a: JaxGenerator(jcfg).init(
        *a, warp_prev=True, train=False), jax.random.PRNGKey(0), *map(jnp.asarray, (
            label, ref_label, images, label, images[:, 0])))["params"]
    want = {}
    for path, selected in flatten_dict(jft.finetune_mask({"G": params})).items():
        module = torch_key(path[1:-1], tcfg)    # path: ("G", *modules, leaf)
        want.setdefault(module, set()).add(bool(selected))
    got = {}
    for name, selected in tft.finetune_mask(build_generator(tcfg, device="cpu")).items():
        got.setdefault(name.rsplit(".", 1)[0], set()).add(selected)
    assert all(len(v) == 1 for v in want.values()) and all(len(v) == 1 for v in got.values())
    assert got == want
    n_selected = sum(v == {True} for v in got.values())
    assert 0 < n_selected < len(got)


def test_random_roll_equals_jax():
    """Several seeds, a map too small to shift (h // 16 == 0) and one
    that is not; labels and images rolled and flipped together."""
    for seed in range(8):
        for shape in ((1, 8, 12, 1), (2, 40, 72, 3)):
            arrays = [np.random.RandomState(seed).randn(*shape).astype(np.float32),
                      np.arange(np.prod(shape), dtype=np.float32).reshape(shape)]
            rng_j, rng_t = np.random.RandomState(seed), np.random.RandomState(seed)
            want = [np.asarray(a) for a in jft.random_roll_np(arrays, rng_j)]
            got = tft.random_roll_np(arrays, rng_t)
            for g, w in zip(got, want):
                assert isinstance(g, np.ndarray) and g.flags.c_contiguous
                np.testing.assert_array_equal(g, w)
            assert rng_t.randint(1 << 30) == rng_j.randint(1 << 30)   # same draws


def test_two_finetune_steps_match_jax(monkeypatch):
    rng = np.random.RandomState(3)
    kw = dict(TINY, is_train=False, finetune=True, finetune_iters=ITERS, lr=LR)
    jcfg = jconfig.pose_config(**kw, compute_dtype="float32")
    tcfg = tconfig.pose_config(**kw, compute_dtype="float32")
    assert tcfg.add_face_D and tcfg.remat and tcfg.concat_ref_for_D
    h, w = jcfg.height, jcfg.width
    ref_labels = pose_label(rng, 1, h, w)[:, None]
    ref_images = np.tanh(rng.randn(1, 1, h, w, 3)).astype(np.float32)
    jmodels = jstate.build_models(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in dict(
        tgt_label=ref_labels[:, 0], tgt_image=ref_images[:, 0],
        ref_labels=ref_labels, ref_images=ref_images).items()}
    st = redrawn_state(jcfg, jmodels, jbatch, rng)
    assert set(st.params_D) == {"D", "DT", "Df"}

    recorded = []
    step = jft._finetune_step

    def recording(*args):
        out = step(*args)
        recorded.append(jax.device_get(out[2]))
        return out
    monkeypatch.setattr(jft, "_finetune_step", recording)
    jst = jft.finetune(jcfg, jmodels, st, jnp.asarray(ref_labels),
                       jnp.asarray(ref_images), seed=4)

    models = port_models(tcfg, st)
    before = {n: p.detach().clone() for n, p in models.netG.named_parameters()}
    before_D = {n: p.detach().clone() for n, p in models.netD.named_parameters()}
    state, history = tft.finetune(tcfg, models, ref_labels, ref_images, seed=4)
    assert state.step == len(history) == len(recorded) == ITERS
    for it, (got, want) in enumerate(zip(history, recorded)):
        assert set(got) == set(want) | {"G_total", "D_total"}
        for key in sorted(want):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=LOSS_RTOL,
                                       atol=1e-6, err_msg=f"step {it} {key}")
        for key in ("G_GAN", "G_VGG", "D_real", "D_fake", "Df_real", "Gf_GAN"):
            assert float(got[key]) > 0, key
        for key in ("F_Flow", "F_Warp"):   # no flow ground truth in finetune
            assert float(got[key]) == 0, key

    mask = tft.finetune_mask(models.netG)
    after = dict(models.netG.named_parameters())
    want_G = state_dict_from_jax(to_numpy(dict(jst.aux_G["G"], params=jst.params_G["G"])),
                                 tcfg)
    moved = 0
    for name, p in after.items():
        if mask[name]:
            moved += int(not torch.equal(p, before[name]))
            np.testing.assert_allclose(p.detach().numpy(), want_G[name].numpy(),
                                       atol=4 * LR, rtol=0, err_msg=name)
        else:
            assert torch.equal(p, before[name]), name
            np.testing.assert_array_equal(want_G[name].numpy(), before[name].numpy())
        assert p.requires_grad, name
    assert moved > 0.5 * sum(mask.values())
    assert all(not torch.equal(p, before_D[n]) for n, p in models.netD.named_parameters())
