"""Test-time finetune at K = 3 references against the JAX package's
(fsvid2vid_tpu/inference/finetune.py), on the CPU in f32.

Each finetune step takes one of the K references as its target (rolled and
flipped) and runs the generator in train mode through the differentiable
K > 1 attention (`chunked_ref_attention`, 4 query chunks on both sides).
Everything before the attention lies outside the finetune mask, so the
attention runs on frozen inputs.

  * `finetune_mask` at K = 3 selects the modules the JAX mask selects (the
    attention's encoders stay out), as tests/test_torch_finetune.py checks
    at K = 1;
  * two finetune steps of a tiny face model (VGG loss off: it does not
    depend on K and halves the JAX compile) from one shared state, at
    tests/test_torch_finetune.py's tolerances: each step's losses 1e-4
    relative; the G parameters in the mask within 4 lr of JAX's after two
    steps (Adam's first steps move each by at most its learning rate, lr /
    2 for G, and may differ in sign where a gradient is ~0); the others
    bitwise unchanged on both sides; the discriminators' within 8 lr (their
    rate is 2 lr); every G buffer (spectral u / v, batch statistics) equal
    to JAX's aux_G to 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict

from fsvid2vid_tpu import config as jconfig
from fsvid2vid_tpu.inference import finetune as jft
from fsvid2vid_tpu.models.generator import FewShotGenerator as JaxGenerator
from fsvid2vid_tpu.models.vgg import Vgg19Features
from fsvid2vid_tpu.training import state as jstate
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.inference import finetune as tft
from fsvid2vid_tpu_torch.models import build_generator
from fsvid2vid_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax, state_dict_from_jax, torch_key)
from tests.test_torch_data import few_threads  # noqa: F401 (autouse)
from tests.test_torch_finetune import TINY
from tests.test_torch_layers import to_numpy
from tests.test_torch_street_step import redrawn_state
from tests.test_torch_train_step_k3 import port_models

K = 3
LR = 1e-6
LOSS_RTOL = 1e-4
STATE_ATOL = 1e-4
HW = (TINY["fine_size"] // 4) ** 2
CHUNK_ELEMS = K * HW * HW // 4      # 4 query chunks


def test_finetune_mask_at_k3_selects_the_jax_modules():
    jcfg = jconfig.face_config(**dict(TINY, n_shot=K))
    tcfg = tconfig.Config.from_json(jcfg.to_json())
    h, w, cl = jcfg.height, jcfg.width, jcfg.gen_input_nc
    z = lambda *s: jnp.zeros(s)
    params = jax.eval_shape(lambda *a: JaxGenerator(jcfg).init(
        *a, warp_prev=True, train=False), jax.random.PRNGKey(0), z(1, h, w, cl),
        z(1, K, h, w, cl), z(1, K, h, w, 3), z(1, h, w, cl), z(1, h, w, 3))["params"]
    want = {}
    for path, selected in flatten_dict(jft.finetune_mask({"G": params})).items():
        want.setdefault(torch_key(path[1:-1], tcfg), set()).add(bool(selected))
    got = {}
    for name, selected in tft.finetune_mask(build_generator(tcfg, device="cpu")).items():
        got.setdefault(name.rsplit(".", 1)[0], set()).add(selected)
    assert got == want
    atn = [m for m in got if m.startswith("atn_")]
    assert len({m.split(".")[0] for m in atn}) == 6 and all(got[m] == {False} for m in atn)


def test_two_finetune_steps_at_k3_match_jax(monkeypatch):
    rng = np.random.RandomState(12)
    kw = dict(TINY, n_shot=K, is_train=False, finetune=True, finetune_iters=2, lr=LR,
              no_vgg_loss=True)
    jcfg = jconfig.face_config(**kw, compute_dtype="float32")
    tcfg = tconfig.face_config(**kw, compute_dtype="float32")
    h, w, cl = jcfg.height, jcfg.width, jcfg.gen_input_nc
    ref_labels = rng.randn(1, K, h, w, cl).astype(np.float32)
    ref_images = np.tanh(rng.randn(1, K, h, w, 3)).astype(np.float32)
    jmodels = dataclasses.replace(jstate.build_models(jcfg),
                                  netG=JaxGenerator(jcfg, atn_chunk_elems=CHUNK_ELEMS))
    jbatch = {k: jnp.asarray(v) for k, v in dict(
        tgt_label=ref_labels[:, 0], tgt_image=ref_images[:, 0],
        ref_labels=ref_labels, ref_images=ref_images).items()}
    st = redrawn_state(jcfg, dataclasses.replace(jmodels, vgg=Vgg19Features()), jbatch,
                       rng).replace(vgg_params=None)

    recorded = []
    step = jft._finetune_step

    def recording(*args):
        out = step(*args)
        recorded.append(jax.device_get(out[2]))
        return out
    monkeypatch.setattr(jft, "_finetune_step", recording)
    jst = jft.finetune(jcfg, jmodels, st, jnp.asarray(ref_labels), jnp.asarray(ref_images),
                       seed=7)

    models = port_models(tcfg, st)
    models.netG.atn_chunk_elems = CHUNK_ELEMS
    before = {n: p.detach().clone() for n, p in models.netG.named_parameters()}
    state, history = tft.finetune(tcfg, models, ref_labels, ref_images, seed=7)
    assert state.step == len(history) == len(recorded) == 2
    for it, (got, want) in enumerate(zip(history, recorded)):
        assert set(got) == set(want) | {"G_total", "D_total"}
        for key in sorted(want):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=LOSS_RTOL,
                                       atol=1e-6, err_msg=f"step {it} {key}")
        for key in ("G_GAN", "D_real", "D_fake"):
            assert float(got[key]) > 0, key

    mask = tft.finetune_mask(models.netG)
    want_G = state_dict_from_jax(to_numpy(dict(jst.aux_G["G"], params=jst.params_G["G"])),
                                 tcfg)
    moved = 0
    for name, p in models.netG.named_parameters():
        if mask[name]:
            moved += int(not torch.equal(p, before[name]))
            np.testing.assert_allclose(p.detach().numpy(), want_G[name].numpy(),
                                       atol=4 * LR, rtol=0, err_msg=name)
        else:
            assert torch.equal(p, before[name]), name
            np.testing.assert_array_equal(want_G[name].numpy(), before[name].numpy())
    assert moved > 0.5 * sum(mask.values())
    for key, value in models.netG.state_dict().items():
        if key.endswith(("weight_u", "weight_v", "running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), want_G[key].numpy(), atol=STATE_ATOL,
                                       err_msg=key)
    for key in ("D", "DT"):
        want_D = discriminator_state_dict_from_jax(to_numpy(dict(
            jst.aux_D[key], params=jst.params_D[key])))
        for name, p in getattr(models, "net" + key).named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want_D[name].numpy(),
                                       atol=8 * LR, rtol=0, err_msg=f"{key} {name}")
    assert all(not torch.equal(p, q) for p, q in zip(
        models.netD.parameters(), port_models(tcfg, st).netD.parameters()))

