"""The port's generator and serving pipeline against the JAX package, on the
CPU, at tiny_face_cfg size (ngf = nff = 4, 64 px, n_blocks_F = 2).

The JAX variables are shaped by `jax.eval_shape` of the generator's init and
drawn from numpy (`randomize`, tests/test_torch_layers.py); the JAX side
folds spectral norm with its fold_spectral_norm, the port loads the same
variables through `state_dict_from_jax` and folds with its own.  For K = 3
the JAX generator is built with atn_flash="interpret", so the Pallas kernel
is on the oracle's path.  The JAX side keeps its space-to-depth eval layout
(spd_inference, exact math).

Tolerance 1e-4 on images (tanh outputs) and 20 x 1e-4 on flows (scaled by
flow_multiplier = 20): the same f32 arithmetic summed in another order; the
measured maxima are about 1e-5 on images.  ref_idx, which picks the
reference image the flow network warps, is compared frame by frame first,
with a margin check: the top two attention masses must differ by 100 times
their tolerance (hw x 1e-5), so an argmax flip would be a real gap.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.inference.fold import fold_spectral_norm as jax_fold
from fsvid2vid_tpu.inference.pipeline import run_sequence as jax_run_sequence
from fsvid2vid_tpu.models.generator import FewShotGenerator as JaxGenerator
from fsvid2vid_tpu.training.state import build_models
from fsvid2vid_tpu.utils.torch_port import import_fewshot_generator
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.inference.fold import fold_spectral_norm
from fsvid2vid_tpu_torch.inference.pipeline import InferencePipeline, run_sequence
from fsvid2vid_tpu_torch.models import build_generator
from fsvid2vid_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_networks import tiny_face_cfg
from tests.test_torch_layers import randomize, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG_ATOL = 1e-4
FLOW_ATOL = 20 * 1e-4
VIS_ATOL = 1e-5
T = 3


class Pair:
    """A JAX generator and the port's, with the same random variables."""

    def __init__(self, n_shot, seed=None, **cfg_kw):
        rng = np.random.RandomState(n_shot if seed is None else seed)
        self.cfg = cfg = tiny_face_cfg(n_shot=n_shot, batch_size=1,
                                       is_train=False, **cfg_kw)
        self.k = n_shot
        h, w, cl = cfg.height, cfg.width, cfg.gen_input_nc
        self.labels = rng.randn(T, 1, h, w, cl).astype(np.float32)
        self.ref_labels = rng.randn(1, n_shot, h, w, cl).astype(np.float32)
        self.ref_images = np.tanh(rng.randn(1, n_shot, h, w, 3)).astype(np.float32)
        self.prev_image = np.tanh(rng.randn(1, h, w, 3)).astype(np.float32)
        self.jm = JaxGenerator(cfg, atn_flash="interpret")
        n = max(1, cfg.n_frames_G - 1)   # the ring's slots: the flow network's inputs
        shapes = jax.eval_shape(
            lambda *a: self.jm.init(*a, warp_prev=True, train=False),
            jax.random.PRNGKey(0), *map(jnp.asarray, (
                self.labels[0], self.ref_labels, self.ref_images,
                np.concatenate([self.labels[1]] * n, -1),
                np.concatenate([self.prev_image] * n, -1))))
        self.variables = randomize(shapes, rng)
        self.folded = jax_fold(self.variables)
        self.tcfg = tconfig.Config.from_json(cfg.to_json())
        self.g = build_generator(self.tcfg, device="cpu")
        self.g.load_state_dict(
            state_dict_from_jax(to_numpy(self.variables), self.tcfg), strict=True)
        fold_spectral_norm(self.g)

    def jax_attention_masses(self):
        """atn_sum (B, K) of each frame's label, from the JAX generator."""
        fn = jax.jit(lambda v, lbl: self.jm.apply(
            v, jnp.asarray(self.ref_images), jnp.asarray(self.ref_labels), lbl,
            method=lambda m, i, l, x: m.weight_generation(i, l, x)[1]["atn"]))
        return [np.asarray(fn(self.folded, jnp.asarray(lbl))) for lbl in self.labels]

    def port_attention_masses(self):
        with torch.no_grad():
            return [self.g.weight_generation(
                nchw(self.ref_images), nchw(self.ref_labels), nchw(lbl))[1]["atn"]
                .numpy() for lbl in self.labels]


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, -3)))


def nhwc(t):
    return t.detach().movedim(-3, -1).numpy()


_PAIRS = {}


def get_pair(n_shot):
    if n_shot not in _PAIRS:
        _PAIRS[n_shot] = Pair(n_shot)
    return _PAIRS[n_shot]


def test_ref_idx_matches_jax_frame_by_frame():
    pair = get_pair(3)
    hw = (pair.cfg.height // 2 ** pair.cfg.n_downsample_A) ** 2
    for ja, ta in zip(pair.jax_attention_masses(), pair.port_attention_masses()):
        top2 = np.sort(ja[0])[-2:]
        assert top2[1] - top2[0] >= 100 * hw * VIS_ATOL
        np.testing.assert_allclose(ta, ja, atol=hw * VIS_ATOL)
        assert np.argmax(ta, 1).tolist() == np.argmax(ja, 1).tolist()


def test_run_sequence_matches_jax():
    """K = 3, T = 3 frames: frame 0 without prevs, then warp_prev."""
    run_sequence_matches(get_pair(3))


def run_sequence_matches(pair):
    models = dataclasses.replace(build_models(pair.cfg), netG=pair.jm)
    v = pair.variables
    want = np.asarray(jax_run_sequence(
        pair.cfg, models, {"G": v["params"]},
        {"G": {c: x for c, x in v.items() if c != "params"}},
        jnp.asarray(pair.labels), jnp.asarray(pair.ref_labels),
        jnp.asarray(pair.ref_images)))
    got = run_sequence(pair.tcfg, pair.g, pair.labels, pair.ref_labels,
                       pair.ref_images).numpy()
    assert got.shape == want.shape == (T, 1, pair.cfg.height, pair.cfg.width, 3)
    assert want.std() > 0.02   # outputs well above the tolerance
    np.testing.assert_allclose(got, want, atol=IMG_ATOL)

    # the stateful pipeline gives the same frames as run_sequence
    # (n_frames_G = 2: its zero-initialised prevs are never read at t = 0)
    pipe = InferencePipeline(pair.tcfg, pair.g)
    pipe.reset(pair.ref_labels, pair.ref_images, pair.labels[0])
    for t in range(T):
        np.testing.assert_allclose(pipe.step(pair.labels[t])["fake_image"].numpy(),
                                   got[t], atol=1e-6)


def test_forward_with_prefix_matches_jax():
    """K = 3: __call__ with the encode_reference_multi prefix and a previous
    frame (warp_prev): images, flows, masks, warps, atn_vis and ref_idx."""
    run_forward_with_prefix(get_pair(3))


def run_forward_with_prefix(pair):
    args = tuple(map(jnp.asarray, (pair.labels[1], pair.ref_labels,
                                   pair.ref_images, pair.labels[0],
                                   pair.prev_image)))
    jm = pair.jm

    @jax.jit
    def jax_forward(v, label, label_refs, img_refs, prev_l, prev_i):
        prefix = jm.apply(v, label_refs, img_refs,
                          method=jm.encode_reference_multi)
        return jm.apply(v, label, label_refs, img_refs, prev_l, prev_i,
                        warp_prev=True, train=False, prefix=prefix)

    want = jax_forward(pair.folded, *args)
    with torch.no_grad():
        prefix = pair.g.encode_reference_multi(nchw(pair.ref_labels),
                                               nchw(pair.ref_images))
        got = pair.g(*map(nchw, (pair.labels[1], pair.ref_labels,
                                 pair.ref_images, pair.labels[0],
                                 pair.prev_image)),
                     warp_prev=True, prefix=prefix)
    for name, atol in (("img_final", IMG_ATOL), ("img_raw", IMG_ATOL),
                       ("flow", FLOW_ATOL), ("flow_mask", IMG_ATOL),
                       ("img_warp", IMG_ATOL)):
        g_, w_ = got[name], want[name]
        for g1, w1 in (zip(g_, w_) if isinstance(w_, list) else [(g_, w_)]):
            assert (g1 is None) == (w1 is None), name
            if w1 is not None:
                np.testing.assert_allclose(nhwc(g1), np.asarray(w1), atol=atol,
                                           err_msg=name)
    if pair.k > 1:
        np.testing.assert_allclose(got["atn_vis"].numpy(),
                                   np.asarray(want["atn_vis"]), atol=VIS_ATOL)
        assert got["ref_idx"].tolist() == np.asarray(want["ref_idx"]).tolist()
    else:
        assert got["ref_idx"] is None and want["ref_idx"] is None


# ----------------------------------------------------------------------
# names, round trip, isolation, device
# ----------------------------------------------------------------------
def fixture_config(sd):
    """The config of scripts/convergence_check.py:261-262, with ngf and the
    size read from the tensor shapes."""
    ngf = sd["ref_img_first.conv.weight_orig"].shape[0]
    return tconfig.face_config(ngf=ngf, nff=ngf, ndf=ngf, n_blocks_F=2,
                               n_downsample_G=3, n_adaptive_layers=2,
                               is_train=False)


def test_reference_checkpoint_loads_strictly():
    """The reference's torch names: all 596 keys of a committed init."""
    path = os.path.join(REPO, "convergence_r4_faithful.json.init.pt")
    sd = torch.load(path, map_location="cpu", weights_only=True)["G"]
    assert len(sd) == 596
    g = build_generator(fixture_config(sd), device="cpu")
    g.load_state_dict(sd, strict=True)
    assert torch.equal(g.flow_network_temp.down_flow[0][0].weight_orig,
                       sd["flow_network_ref.down_flow.0.0.weight_orig"])


def test_state_dict_round_trip_through_jax_importer():
    """port state_dict -> JAX import_fewshot_generator -> state_dict_from_jax
    gives back the same tensors."""
    cfg = tiny_face_cfg(n_shot=3, batch_size=1, is_train=False)
    h, w, cl = cfg.height, cfg.width, cfg.gen_input_nc
    z = lambda *s: jnp.zeros(s, jnp.float32)
    shapes = jax.eval_shape(
        lambda *a: JaxGenerator(cfg).init(*a, warp_prev=True, train=False),
        jax.random.PRNGKey(0), z(1, h, w, cl), z(1, 3, h, w, cl),
        z(1, 3, h, w, 3), z(1, h, w, cl), z(1, h, w, 3))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    tcfg = tconfig.Config.from_json(cfg.to_json())
    sd = build_generator(tcfg, device="cpu",
                         generator=torch.Generator().manual_seed(3)).state_dict()
    imported = import_fewshot_generator(
        template, {k: v.numpy() for k, v in sd.items()}, cfg)
    back = state_dict_from_jax(imported, tcfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import with jax, flax
    and fsvid2vid_tpu blocked."""
    code = f"""
import importlib, importlib.util, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "fsvid2vid_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {REPO!r})
import fsvid2vid_tpu_torch
names = [m.name for m in pkgutil.walk_packages(fsvid2vid_tpu_torch.__path__,
                                                "fsvid2vid_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {os.path.join(REPO, "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not any(m.split(".")[0] in ("jax", "flax", "fsvid2vid_tpu") for m in sys.modules)
print(" ".join(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd="/", env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 27
    assert {"fsvid2vid_tpu_torch." + m for m in (
        "ops.cuda_build", "ops.cost_volume", "ops.attention_kernel",
        "models.flownet.flownet2", "models.discriminator", "models.vgg",
        "losses.gan", "losses.collector", "training.flow_teacher",
        "training.state", "training.step", "ops.crop", "models.face_refiner",
        "models.remat", "data.pose", "data.synthetic", "data.rasterize",
        "data.loader", "ops", "ops.image_ops", "ops.batch_conv", "models.layers",
        "models.generator", "utils.convert", "inference.finetune", "cli.train",
        "cli.test")} <= names


def test_entry_points_run_on_cuda_unless_cpu_is_named():
    cfg = tconfig.face_config(ngf=4, nff=4, fine_size=32, load_size=32,
                              n_blocks_F=1, n_downsample_G=2, n_adaptive_layers=1)
    if torch.cuda.is_available():
        assert build_generator(cfg).conv_img.weight.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_generator(cfg)
    assert build_generator(cfg, device="cpu").conv_img.weight.device.type == "cpu"
