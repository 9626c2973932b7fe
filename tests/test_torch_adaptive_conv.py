"""The port's generated main-branch conv weights (adaptive_conv) against the
JAX package's, on the CPU in f32 at a tiny face configuration (ngf 4,
32 px, three downsamplings, two adaptive layers, batch 2):

  * `SpadeResnetBlock(conv_params_free=True)` with numpy-drawn per-sample
    weights, a learned shortcut and without, stride 1 and 2: 1e-5 (three
    small convolutions in another order);
  * the generator's parameter names and shapes equal the JAX init's under
    `state_dict_from_jax` (the `fc_conv_{0,1,s}_<i>` stacks present, no
    conv of `up_<i>` for i < n_adaptive_layers), a strict load, and back
    through the JAX package's `import_fewshot_generator` unchanged;
  * the eval forward at K = 1 and K = 2 (kernel B1's plain version on the
    CPU) with and without the previous frame: frames 1e-4
    (tests/test_torch_generator.py's tolerance);
  * `encode_reference` + `synthesize` equal `forward` at K = 1 (1e-6: the
    same operations), and the cache carries the generated conv weights;
  * refine_face with adaptive_conv fails in the JAX package (its init
    raises TypeError: 'NoneType' object is not subscriptable) and the port
    refuses it, naming that failure.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from fsvid2vid_tpu.config import face_config as jface
from fsvid2vid_tpu.config import pose_config as jpose
from fsvid2vid_tpu.models import layers as jl
from fsvid2vid_tpu.models.generator import FewShotGenerator as JaxGenerator
from fsvid2vid_tpu.training import state as jstate
from fsvid2vid_tpu.utils.torch_port import import_fewshot_generator
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.models import build_generator
from fsvid2vid_tpu_torch.models import layers as tl
from fsvid2vid_tpu_torch.models.face_refiner import check_refine_face
from fsvid2vid_tpu_torch.training.state import build_models
from fsvid2vid_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_data import few_threads  # noqa: F401 (autouse)
from tests.test_torch_layers import jax_apply, nchw, nhwc, port_module, randomize, to_numpy

BLOCK_ATOL = 1e-5
ATOL = 1e-4
CACHE_ATOL = 1e-6
B, SIZE, N_ADAPTIVE = 2, 32, 2
TINY = dict(ngf=4, nff=4, ndf=4, fine_size=SIZE, load_size=SIZE, n_blocks_F=2,
            n_downsample_G=3, n_adaptive_layers=N_ADAPTIVE, adaptive_conv=True)


@pytest.mark.parametrize("fin,fout,stride", [(8, 4, 1), (4, 4, 1), (4, 8, 2)],
                         ids=["shortcut", "identity", "stride2"])
def test_params_free_block_matches_jax(rng, fin, fout, stride):
    b, k = 2, 3
    fh = min(fin, fout)
    x = rng.randn(b, 8, 8, fin).astype(np.float32)
    maps = [rng.randn(b, 16, 16, 4).astype(np.float32)]
    mk = lambda *s: (rng.randn(*s) / np.sqrt(np.prod(s[2:]))).astype(np.float32)
    # torch layout per sample: (B, Cout, Cin, k, k) and (B, Cout)
    weights = [(mk(b, fh, fin, k, k), 0.1 * mk(b, fh)), (mk(b, fout, fh, k, k), 0.1 * mk(b, fout)),
               (mk(b, fout, fin, 1, 1), 0.1 * mk(b, fout))]
    jw = [(jnp.asarray(w.transpose(0, 3, 4, 2, 1)), jnp.asarray(bias)) for w, bias in weights]
    jm = jl.SpadeResnetBlock(fin, fout, norm="spectralspadesyncbatch", hidden_ncs=[4],
                             stride=stride, conv_params_free=True)
    jlabel = [jnp.asarray(maps[0])]
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jlabel, jw), rng)
    assert not any(name.startswith("conv_") for name in v["params"])
    want = jax_apply(jm, v, jnp.asarray(x), jlabel, jw)
    tm = port_module(tl.SpadeResnetBlock(fin, fout, "spectralspadesyncbatch", [4],
                                         stride=stride, conv_params_free=True), v)
    assert not any(n.startswith("conv_") for n, _ in tm.named_children())
    tw = [(torch.from_numpy(w), torch.from_numpy(bias)) for w, bias in weights]
    got = tm(nchw(x), [nchw(maps[0])], conv_weights=tw)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=BLOCK_ATOL)
    with pytest.raises(ValueError, match="conv_weights"):
        tm(nchw(x), [nchw(maps[0])])


def configs(k, **kw):
    jcfg = jface(**dict(TINY, n_shot=k, batch_size=B, compute_dtype="float32", **kw))
    return jcfg, tconfig.Config.from_json(jcfg.to_json())


def inputs(rng, k, b=B):
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    return (mk(b, SIZE, SIZE, 1), mk(b, k, SIZE, SIZE, 1), np.tanh(mk(b, k, SIZE, SIZE, 3)),
            mk(b, SIZE, SIZE, 1), np.tanh(mk(b, SIZE, SIZE, 3)))


def port_inputs(arrays):
    return [torch.from_numpy(a).movedim(-1, -3) for a in arrays]


@pytest.fixture(scope="module", params=[1, 2], ids=["k1", "k2"])
def generators(request):
    return make_generators(request.param)


def make_generators(k):
    """The JAX generator's variables (shaped by its init) redrawn from
    numpy, and the port's generator holding them."""
    rng = np.random.RandomState(50 + k)
    jcfg, tcfg = configs(k)
    jm = JaxGenerator(jcfg)
    args = [jnp.asarray(a) for a in inputs(rng, k)]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args, warp_prev=True,
                                            train=True))
    v = randomize(shapes, rng)
    g = build_generator(tcfg, device="cpu")
    g.load_state_dict(state_dict_from_jax(to_numpy(v), tcfg), strict=True)
    return k, jcfg, tcfg, jm, v, g


def test_names_and_shapes_follow_the_jax_init(generators):
    k, jcfg, tcfg, jm, v, g = generators
    sd = state_dict_from_jax(to_numpy(v), tcfg)
    own = g.state_dict()
    assert set(sd) == set(own)
    assert all(tuple(sd[n].shape) == tuple(t.shape) for n, t in own.items())
    for i in range(N_ADAPTIVE):
        for kind in ("0", "1", "s"):
            assert f"fc_conv_{kind}_{i}.4.weight_orig" in own     # 2 fc layers + out
        assert not any(n.startswith(f"up_{i}.conv_") for n in own)
    assert any(n.startswith(f"up_{N_ADAPTIVE}.conv_0.") for n in own)
    # conv_0 of up_1 maps ch[2] = 16 to ch[1] = 8 at k = 3: 8 rows of 16 * 9 + 1
    assert g.fc_conv_0_1[-1].weight_orig.shape[0] == 16 * 9 + 1
    assert g.fc_conv_0_1[0].weight_orig.shape[1] == 8            # the outer product's rows
    back = flatten_dict(import_fewshot_generator(v, sd, tcfg))
    for path, x in flatten_dict(to_numpy(v)).items():
        np.testing.assert_array_equal(back[path], x, err_msg=str(path))


@pytest.mark.parametrize("prev", [False, True], ids=["first", "warp_prev"])
def test_eval_forward_matches_jax(generators, prev):
    k, jcfg, tcfg, jm, v, g = generators
    arrays = inputs(np.random.RandomState(60 + k), k)
    if not prev:
        arrays = arrays[:3]
    want = jm.apply(v, *map(jnp.asarray, arrays), warp_prev=prev, train=False)
    with torch.no_grad():
        out = g.eval()(*port_inputs(arrays), warp_prev=prev)
    img = np.asarray(want["img_final"])
    assert img.std() > 0.05
    np.testing.assert_allclose(out["img_final"].movedim(1, -1).numpy(), img, atol=ATOL)
    if k > 1:
        assert out["ref_idx"].tolist() == np.asarray(want["ref_idx"]).tolist()


def test_reference_cache_equals_the_forward_at_k1():
    g = make_generators(1)[-1].eval()
    label, ref_l, ref_i, prev_l, prev_i = port_inputs(inputs(np.random.RandomState(70), 1))
    with torch.no_grad():
        cache = g.encode_reference(ref_l, ref_i, label)
        want = g(label, ref_l, ref_i, prev_l, prev_i, warp_prev=True)["img_final"]
        got = g.synthesize(label, ref_l, ref_i, cache, prev_l, prev_i, warp_prev=True)
    assert len(cache["conv_weights"]) == N_ADAPTIVE
    w0, b0 = cache["conv_weights"][0][0]
    assert tuple(w0.shape) == (B, 4, 8, 3, 3) and tuple(b0.shape) == (B, 4)
    assert want.std() > 0.05
    torch.testing.assert_close(got["img_final"], want, atol=CACHE_ATOL, rtol=0)


def test_refine_face_with_adaptive_conv_fails_in_jax_and_is_refused():
    """The JAX face refiner keeps adaptive_conv, and forward_face hands its
    conv_params_free blocks no conv weights, so its init fails; the port
    refuses the combination by that failure."""
    kw = dict(TINY, batch_size=1, refine_face=True)
    jcfg = jpose(**kw, compute_dtype="float32")
    tcfg = tconfig.Config.from_json(jcfg.to_json())
    models = jstate.build_models(jcfg)
    fs = jcfg.fine_size // 4        # the square face crop: 32 / 0.5 // 4 = 16
    rng = np.random.RandomState(0)
    crop = lambda *s: jnp.asarray(np.tanh(rng.randn(*s)).astype(np.float32))
    args = (crop(1, fs, fs, 3), crop(1, 1, fs, fs, 3), crop(1, 1, fs, fs, 3), crop(1, fs, fs, 3))
    with pytest.raises(TypeError, match="'NoneType' object is not subscriptable"):
        jax.eval_shape(lambda: models.netGf.init(jax.random.PRNGKey(0), *args, train=True,
                                                 method=models.netGf.forward_face))
    message = "adaptive_conv.*NoneType' object is not subscriptable.*ROADMAP.md C"
    with pytest.raises(NotImplementedError, match=message):
        check_refine_face(tcfg)
    with pytest.raises(NotImplementedError, match=message):
        build_models(tcfg, device="cpu")
    build_models(tcfg.replace(refine_face=False), device="cpu")   # each alone builds
    build_models(tcfg.replace(adaptive_conv=False), device="cpu")
