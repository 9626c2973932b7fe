"""The PyTorch port's layers, embedders and flow network against flax, on
the CPU, with parameters carried across by `state_dict_from_jax`.

The JAX modules are initialised, then every variable is redrawn from numpy
(`randomize`) so that activations are of order one: the reference's init
(xavier with gain 0.02) would make most outputs nearly zero and any
tolerance vacuous.  Batch-norm running statistics are random (mean
N(0, 0.3), var U(0.5, 1.5)), so the eval norms are really exercised, and
spectral-norm u / v are the leading singular vectors, so sigma is the
spectral norm.  The JAX side is folded with its fold_spectral_norm, the port
with its own.

Tolerance 1e-4 (absolute, on outputs of order one): the same f32 arithmetic,
with convolution sums in another order and batch norm applied as one
scale-and-shift.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from fsvid2vid_tpu.config import face_config
from fsvid2vid_tpu.inference.fold import fold_spectral_norm as jax_fold
from fsvid2vid_tpu.models import layers as jl
from fsvid2vid_tpu.models.embedder import LabelEmbedder as JaxEmbedder
from fsvid2vid_tpu.models.flow_generator import FlowGenerator as JaxFlow
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.inference.fold import fold_spectral_norm
from fsvid2vid_tpu_torch.models import layers as tl
from fsvid2vid_tpu_torch.models.embedder import LabelEmbedder
from fsvid2vid_tpu_torch.models.flow_generator import FlowGenerator
from fsvid2vid_tpu_torch.utils.convert import state_dict_from_jax

ATOL = 1e-4


# ----------------------------------------------------------------------
# helpers shared with test_torch_generator.py
# ----------------------------------------------------------------------
def _top_singular(mat, rng, iters=30):
    u = rng.randn(mat.shape[0])
    for _ in range(iters):
        v = mat.T @ u
        v /= np.linalg.norm(v)
        u = mat @ v
        u /= np.linalg.norm(u)
    return u.astype(np.float32), v.astype(np.float32)


def randomize(variables, rng):
    """Redraw every variable of a flax tree from numpy: kernels
    N(0, 1/fan_in), biases N(0, 0.1), norm scales 1 + N(0, 0.1), running
    stats as in the module docstring, spectral u / v from the kernels."""
    flat = {c: flatten_dict(jax.device_get(v)) for c, v in variables.items()}
    params = {}
    for path, x in flat["params"].items():
        leaf = path[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            params[path] = rng.randn(*x.shape) / np.sqrt(fan_in)
        elif leaf == "scale":
            params[path] = 1 + 0.1 * rng.randn(*x.shape)
        else:
            params[path] = 0.1 * rng.randn(*x.shape)
    out = {"params": params}
    if "batch_stats" in flat:
        out["batch_stats"] = {
            p: (0.3 * rng.randn(*x.shape) if p[-1] == "mean"
                else rng.uniform(0.5, 1.5, x.shape))
            for p, x in flat["batch_stats"].items()}
    if "spectral" in flat:
        spec = {}
        for p in flat["spectral"]:
            if p[-1] != "u":
                continue
            k = params[p[:-1] + ("kernel",)]
            mat = (k.transpose(3, 2, 0, 1).reshape(k.shape[3], -1)
                   if k.ndim == 4 else k.T)
            spec[p], spec[p[:-1] + ("v",)] = _top_singular(mat, rng)
        out["spectral"] = spec
    return {c: unflatten_dict({p: jnp.asarray(np.asarray(x, np.float32))
                               for p, x in tree.items()})
            for c, tree in out.items()}


def to_numpy(variables):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def port_module(module, variables, name=None):
    """Load JAX variables into a port module (strictly), fold, eval.  With
    `name`, both sit under that generator attribute, whose torch names the
    converter derives from it (the embedders' and flow networks')."""
    variables = to_numpy(variables)
    holder = module
    if name is not None:
        variables = {c: {name: t} for c, t in variables.items()}
        holder = torch.nn.Module()
        setattr(holder, name, module)
    # n_frames_G = 1: no shared temporal network to register a second time
    cfg = tconfig.face_config(n_frames_G=1)
    holder.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return fold_spectral_norm(module.eval())


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def jax_apply(module, variables, *args, **kw):
    return module.apply(jax_fold(variables), *args, mutable=False, **kw)


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("k,stride,bias", [(3, 1, True), (3, 2, True), (1, 2, False)])
def test_snconv_folded_matches_flax(rng, k, stride, bias):
    x = rng.randn(2, 9, 10, 5).astype(np.float32)
    jm = jl.SNConv(7, k, stride, use_bias=bias)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = jax_apply(jm, v, jnp.asarray(x))
    tm = port_module(tl.SNConv(5, 7, k, stride, bias=bias), v)
    assert tm.folded
    np.testing.assert_allclose(nhwc(tm(nchw(x))), np.asarray(ref), atol=ATOL)


def test_sndense_folded_matches_flax(rng):
    x = rng.randn(6, 11).astype(np.float32)
    jm = jl.SNDense(9)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = jax_apply(jm, v, jnp.asarray(x))
    tm = port_module(tl.SNLinear(11, 9), v)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref), atol=ATOL)


def test_sn_unfolded_equals_folded(rng):
    """The live sigma (stored u / v) and the folded weight agree."""
    jm = jl.SNConv(6, 3)
    x = rng.randn(1, 8, 8, 4).astype(np.float32)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    tm = tl.SNConv(4, 6, 3).eval()
    tm.load_state_dict(state_dict_from_jax(to_numpy(v), tconfig.face_config()))
    live = tm(nchw(x))
    np.testing.assert_allclose(fold_spectral_norm(tm)(nchw(x)).detach().numpy(),
                               live.detach().numpy(), atol=1e-5)


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_plain_norms_match_flax(rng, norm):
    x = (2 * rng.randn(2, 6, 7, 5) + 0.5).astype(np.float32)
    jm = jl.make_plain_norm(norm, 5)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = jax_apply(jm, v, jnp.asarray(x))
    tm = port_module(tl.make_plain_norm(norm, 5), v)
    np.testing.assert_allclose(nhwc(tm(nchw(x))), np.asarray(ref), atol=ATOL)


def test_spade_generated_weights_matches_flax(rng):
    """Map 0 with generated per-sample weights, maps 1 and 2 owned, at
    other resolutions than x (nearest resize inside)."""
    b, c = 2, 6
    x = rng.randn(b, 8, 8, c).astype(np.float32)
    maps = [rng.randn(b, 8, 8, 3).astype(np.float32),
            rng.randn(b, 16, 16, 4).astype(np.float32),
            rng.randn(b, 5, 5, 4).astype(np.float32)]
    wg = (0.3 * rng.randn(b, c, 3, 1, 1)).astype(np.float32)   # torch layout
    wb = (0.3 * rng.randn(b, c, 3, 1, 1)).astype(np.float32)
    jw = tuple(jnp.asarray(w.transpose(0, 3, 4, 2, 1)) for w in (wg, wb))
    jm = jl.Spade(c, [3, 4, 4], "spectralspadesyncbatch", 1, params_free=True)
    jmaps = [jnp.asarray(m) for m in maps]
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jmaps,
                          weights=jw), rng)
    ref = jax_apply(jm, v, jnp.asarray(x), jmaps, weights=jw)
    tm = port_module(tl.Spade(c, [3, 4, 4], "spectralspadesyncbatch", 1,
                              params_free=True), v)
    out = tm(nchw(x), [nchw(m) for m in maps],
             weights=(torch.from_numpy(wg), torch.from_numpy(wb)))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL)


def test_spade_conv2d_stride2_matches_flax(rng):
    x = rng.randn(2, 10, 10, 3).astype(np.float32)
    jm = jl.SpadeConv2d(8, norm="spectralsyncbatch", stride=2)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = jax_apply(jm, v, jnp.asarray(x))
    tm = port_module(tl.SpadeConv2d(3, 8, "spectralsyncbatch", stride=2), v)
    np.testing.assert_allclose(nhwc(tm(nchw(x))), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("fin,fout,stride,norm,n_maps", [
    (8, 6, 1, "spectralspadesyncbatch", 3),   # learned shortcut, SPADE
    (6, 6, 2, "spectralsyncbatch", 0),        # stride 2, avg-pool shortcut
    (6, 10, 2, "spectralsyncbatch", 0),       # stride 2, learned shortcut
])
def test_spade_resnet_block_matches_flax(rng, fin, fout, stride, norm, n_maps):
    b = 2
    x = rng.randn(b, 8, 8, fin).astype(np.float32)
    maps = [rng.randn(b, 16, 16, 4).astype(np.float32) for _ in range(n_maps)]
    hidden = [4] * n_maps if n_maps else (0,)
    jm = jl.SpadeResnetBlock(fin, fout, norm=norm, hidden_ncs=hidden,
                             stride=stride)
    jlabel = [jnp.asarray(m) for m in maps] if n_maps else None
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jlabel), rng)
    ref = jax_apply(jm, v, jnp.asarray(x), jlabel)
    tm = port_module(tl.SpadeResnetBlock(fin, fout, norm, hidden,
                                         stride=stride), v)
    out = tm(nchw(x), [nchw(m) for m in maps] if n_maps else None)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL)


# ----------------------------------------------------------------------
# embedders and flow network
# ----------------------------------------------------------------------
def _embedder_weights(rng, b, ch, n_free):
    """Generated (weight, bias) per decoder level i < n_free, torch layout."""
    return [((0.3 * rng.randn(b, ch[i], ch[i + 1], 1, 1)).astype(np.float32),
             (0.1 * rng.randn(b, ch[i])).astype(np.float32))
            for i in range(n_free)]


@pytest.mark.parametrize("arch,n_free", [("encoderdecoder", 2), ("unet", 0),
                                         ("encoder", 0)])
def test_label_embedder_matches_flax(rng, arch, n_free):
    """encoderdecoder with generated 1x1 weights on the two finest decoder
    levels (the label embedding), unet (the warped-image embeddings)."""
    b, nf, nd, cin = 2, 4, 3, 2
    ch = [nf * 2 ** i for i in range(nd + 1)]
    x = rng.randn(b, 16, 16, cin).astype(np.float32)
    ws = _embedder_weights(rng, b, ch, n_free)
    jws = [(jnp.asarray(w.transpose(0, 3, 4, 2, 1)), jnp.asarray(bb))
           for w, bb in ws] or None
    jm = JaxEmbedder(arch=arch, nf=nf, n_downsample=nd,
                     params_free_layers=n_free, spd_inference=True)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jws), rng)
    ref = jax_apply(jm, v, jnp.asarray(x), jws)
    tm = port_module(LabelEmbedder(cin, arch, nf, nd, n_free), v,
                     "label_embedding")
    out = tm(nchw(x), [(torch.from_numpy(w), torch.from_numpy(bb))
                       for w, bb in ws] or None)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(nhwc(o), np.asarray(r), atol=ATOL)


def test_flow_generator_matches_flax(rng):
    """The JAX side runs its space-to-depth eval layout (exact math); the
    port runs the plain layout.  Flows are scaled by flow_multiplier = 20,
    so their tolerance is 20 x 1e-4."""
    jcfg = face_config(nff=4, n_blocks_F=2, spd_inference=True)
    tcfg = tconfig.face_config(nff=4, n_blocks_F=2)
    b, h, w = 2, 16, 16
    args = [rng.randn(b, h, w, 1).astype(np.float32),
            rng.randn(b, h, w, 1).astype(np.float32),
            np.tanh(rng.randn(b, h, w, 3)).astype(np.float32)]
    jm = JaxFlow(jcfg, 2)
    v = randomize(jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, args)), rng)
    flow, mask = jax_apply(jm, v, *map(jnp.asarray, args))
    tm = port_module(FlowGenerator(tcfg, 2), v, "flow_network_ref")
    tflow, tmask = tm(*map(nchw, args))
    assert np.abs(np.asarray(flow)).max() > 1.0
    np.testing.assert_allclose(nhwc(tflow), np.asarray(flow), atol=ATOL * 20)
    np.testing.assert_allclose(nhwc(tmask), np.asarray(mask), atol=ATOL)
