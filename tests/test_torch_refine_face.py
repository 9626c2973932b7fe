"""The port's face refinement (refine_face, netGf) against the JAX
package's, on the CPU in f32, at a tiny pose configuration: ngf 4, 64 x 32
(fine_size 32 at the pose aspect ratio 0.5), three downsamplings, so that
netGf runs two on 16 x 16 face crops, remove_face_labels, labels in
tests/test_pose_training.py's `pose_label` layout (a DensePose face at
parts 23 / 24 with OpenPose channels on it).

  * netGf's parameter and buffer names and shapes equal those the JAX init
    with `method=forward_face` creates (flax builds a submodule only when it
    is called, so netGf has no flow nets, SPADE-combine maps, attention or
    VAE layers), carried through `state_dict_from_jax` and back through the
    JAX package's `import_fewshot_generator` unchanged;
  * `forward_face` in eval and in train mode (with the mutated batch
    statistics and spectral vectors), 1e-4 on the face;
  * `replace_face_region` and `refine_face_region`, 1e-5 on frames;
  * n_shot 2: the JAX init of netGf fails (the fault the port's refusal
    names, ROADMAP.md C) and the port refuses in build_models, in the
    pipeline and on the command line;
  * the K = 1 pipeline with refinement against the JAX InferencePipeline
    over 3 frames, 1e-4 on frames.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from fsvid2vid_tpu.config import pose_config as jpose
from fsvid2vid_tpu.inference.pipeline import InferencePipeline as JaxPipeline
from fsvid2vid_tpu.models import face_refiner as jfr
from fsvid2vid_tpu.models.input_process import use_valid_labels
from fsvid2vid_tpu.training import state as jstate
from fsvid2vid_tpu.utils.torch_port import import_fewshot_generator
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.cli import train as cli_train
from fsvid2vid_tpu_torch.inference.pipeline import InferencePipeline
from fsvid2vid_tpu_torch.models import build_generator, face_refiner as tfr
from fsvid2vid_tpu_torch.models.generator import FewShotGenerator
from fsvid2vid_tpu_torch.training import state as tstate
from fsvid2vid_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_pose_training import pose_label
from tests.test_torch_layers import randomize, to_numpy

FACE_ATOL = 1e-4
FRAME_ATOL = 1e-5
PIPE_ATOL = 1e-4
B = 2
TINY = dict(ngf=4, nff=4, ndf=4, fine_size=32, load_size=32, n_blocks_F=2,
            n_downsample_G=3, n_adaptive_layers=2, refine_face=True, no_vgg_loss=True)


def configs(**kw):
    jcfg = jpose(**dict(TINY, compute_dtype="float32", **kw))
    return jcfg, tconfig.Config.from_json(jcfg.to_json())


def face_inputs(rng, fs, b=B):
    """Face crops: labels (b, fs, fs, 3), one reference (b, 1, fs, fs, 3) of
    each, the coarse face (b, fs, fs, 3)."""
    img = lambda *s: np.tanh(rng.randn(*s)).astype(np.float32)
    return (rng.uniform(-1, 1, (b, fs, fs, 3)).astype(np.float32),
            rng.uniform(-1, 1, (b, 1, fs, fs, 3)).astype(np.float32),
            img(b, 1, fs, fs, 3), img(b, fs, fs, 3))


def jax_gf_variables(jcfg, rng):
    """netGf's variables as the JAX init with method=forward_face shapes
    them (training/state.py:144-152), redrawn from numpy."""
    models = jstate.build_models(jcfg)
    fs = models.netGf.cfg.fine_size
    args = [jnp.asarray(a) for a in face_inputs(np.random.RandomState(0), fs)]
    shapes = jax.eval_shape(lambda: models.netGf.init(
        {"params": jax.random.PRNGKey(0)}, *args, train=True,
        method=models.netGf.forward_face))
    return models, randomize(shapes, rng)


def port_gf(tcfg, variables):
    """The port's netGf in eval mode, holding the JAX variables."""
    fcfg = tfr.face_refiner_config(tcfg)
    gf = FewShotGenerator(fcfg, for_face=True)
    gf.load_state_dict(state_dict_from_jax(to_numpy(variables), fcfg), strict=True)
    return gf.eval()


@pytest.fixture(scope="module")
def gf():
    rng = np.random.RandomState(10)
    jcfg, tcfg = configs(batch_size=B)
    jmodels, v = jax_gf_variables(jcfg, rng)
    return jcfg, tcfg, jmodels, v


def test_netgf_holds_the_jax_variables(gf):
    """Names and shapes both ways: every tensor of the port's netGf has a
    JAX variable and every JAX variable a tensor."""
    jcfg, tcfg, jmodels, v = gf
    want = {k: tuple(t.shape) for k, t in state_dict_from_jax(
        to_numpy(v), tfr.face_refiner_config(tcfg)).items()}
    net = FewShotGenerator(tfr.face_refiner_config(tcfg), for_face=True)
    got = {k: tuple(t.shape) for k, t in net.state_dict().items()}
    assert got == want
    modules = {k.split(".")[0] for k in got}
    assert {"conv_img", "label_embedding", "ref_img_first", "ref_label_first",
            "up_0", "up_1", "up_2"} <= modules
    assert not [m for m in modules if m.startswith(("flow_", "img_", "atn_", "fc_mu"))]
    fcfg = tfr.face_refiner_config(tcfg)
    assert (fcfg.fine_size, fcfg.n_downsample_G, fcfg.n_adaptive_layers, fcfg.input_nc) == (
        16, 2, 1, 3)
    assert fcfg == tconfig.Config.from_json(jmodels.netGf.cfg.to_json())
    # and back through the JAX package's importer, leaf for leaf
    back = import_fewshot_generator(v, state_dict_from_jax(to_numpy(v), fcfg), fcfg)
    for path, x in flatten_dict(to_numpy(v)).items():
        np.testing.assert_array_equal(flatten_dict(back)[path], x, err_msg=str(path))


@pytest.mark.parametrize("train", [False, True])
def test_forward_face_matches_jax(gf, train):
    jcfg, tcfg, jmodels, v = gf
    fs = jmodels.netGf.cfg.fine_size
    args = face_inputs(np.random.RandomState(11), fs)
    want = jmodels.netGf.apply(v, *map(jnp.asarray, args), train=train,
                               method=jmodels.netGf.forward_face,
                               mutable=["spectral", "batch_stats"] if train else False)
    if train:
        want, mutated = want
    net = port_gf(tcfg, v).train(train)
    nchw = lambda a: torch.from_numpy(a).movedim(-1, -3)
    got = net.forward_face(*map(nchw, args))
    want = np.asarray(want)
    assert got.shape == (B, 3, fs, fs) and want.std() > 0.05
    np.testing.assert_allclose(got.detach().movedim(1, -1).numpy(), want, atol=FACE_ATOL)
    if train:   # the batch statistics and spectral vectors moved as JAX's
        after = state_dict_from_jax(to_numpy(dict(v, **mutated)),
                                    tfr.face_refiner_config(tcfg))
        for k, t in net.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(t.numpy(), after[k].numpy(), atol=FACE_ATOL,
                                           err_msg=k)


def test_replace_face_region_matches_jax():
    rng = np.random.RandomState(12)
    jcfg, tcfg = configs()
    h, w, fs = jcfg.height, jcfg.width, jfr.face_size_of(jcfg)
    label = pose_label(rng, B, h, w)
    image = np.tanh(rng.randn(B, h, w, 3)).astype(np.float32)
    face, coarse = (rng.uniform(-1.5, 1.5, (B, fs, fs, 3)).astype(np.float32)
                    for _ in range(2))
    for kw in ({}, {"crop_smaller": 4}):
        want = np.asarray(jfr.replace_face_region(jcfg, jnp.asarray(image), jnp.asarray(face),
                                                  jnp.asarray(label), jnp.asarray(coarse), **kw))
        got = tfr.replace_face_region(tcfg, torch.from_numpy(image), torch.from_numpy(face),
                                      torch.from_numpy(label), torch.from_numpy(coarse), **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=FRAME_ATOL)
        assert np.abs(want - image).max() > 0.1   # the box was pasted
        assert want.min() >= -1 and want.max() <= 1


def test_refine_face_region_matches_jax(gf):
    """The whole refinement with netGf in train mode: crops of the target
    and of the reference, the coarse face detached, the paste; and G's
    gradient reaches the frame only outside the face box."""
    jcfg, tcfg, jmodels, v = gf
    rng = np.random.RandomState(13)
    h, w = jcfg.height, jcfg.width
    label, ref_label = pose_label(rng, B, h, w), pose_label(rng, B, h, w)
    fake = np.tanh(rng.randn(B, h, w, 3)).astype(np.float32)
    ref_image = np.tanh(rng.randn(B, h, w, 3)).astype(np.float32)
    valid = lambda lbl: np.array(use_valid_labels(jcfg, jnp.asarray(lbl)))

    def netgf_apply(*a):
        return jmodels.netGf.apply(v, *a, train=True, method=jmodels.netGf.forward_face,
                                   mutable=["spectral", "batch_stats"])[0]
    want = np.asarray(jfr.refine_face_region(
        jcfg, netgf_apply, jnp.asarray(valid(label)), jnp.asarray(fake), jnp.asarray(label),
        jnp.asarray(valid(ref_label)), jnp.asarray(ref_image), jnp.asarray(ref_label)))
    t = torch.from_numpy
    fake_t = t(fake).requires_grad_(True)
    got = tfr.refine_face_region(tcfg, port_gf(tcfg, v).train(), t(valid(label)), fake_t,
                                 t(label), t(valid(ref_label)), t(ref_image), t(ref_label))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FRAME_ATOL)
    assert np.abs(want - fake).max() > 0.1
    got.sum().backward()
    boxes = tfr.get_face_boxes(tcfg, t(label), crop_smaller=4)
    for i, (ys, ye, xs, xe) in enumerate(boxes.long().tolist()):
        grad = fake_t.grad[i]
        assert (grad[ys:ye, xs:xe] == 0).all()
        assert (grad != 0).sum() == h * w * 3 - (ye - ys) * (xe - xs) * 3


def test_n_shot_2_fails_in_jax_and_is_refused():
    """The JAX refiner keeps n_shot but takes one reference, so its init
    fails at n_shot 2; the port refuses that configuration by name."""
    jcfg, tcfg = configs(batch_size=1, n_shot=2)
    models = jstate.build_models(jcfg)
    args = [jnp.asarray(a) for a in face_inputs(np.random.RandomState(0), 16, b=1)]
    with pytest.raises(TypeError, match="cannot reshape array"):
        jax.eval_shape(lambda: models.netGf.init(jax.random.PRNGKey(0), *args, train=True,
                                                 method=models.netGf.forward_face))
    for build in (lambda: tstate.build_models(tcfg, device="cpu"),
                  lambda: InferencePipeline(tcfg, build_generator(
                      tcfg.replace(refine_face=False), device="cpu"))):
        with pytest.raises(NotImplementedError, match="n_shot 2.*cannot reshape.*ROADMAP.md C"):
            build()
    parser = cli_train.build_arg_parser()
    args = parser.parse_args(["--dataset_mode", "fewshot_pose", "--refine_face",
                              "--n_shot", "2", "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        cli_train.config_from_args(parser, args)
    assert e.value.code != 0


def test_refined_pipeline_matches_jax():
    """3 frames at K = 1 through both InferencePipelines: G's frame, then
    netGf on the face crops of the target and of the first reference."""
    rng = np.random.RandomState(14)
    jcfg, tcfg = configs(batch_size=1, is_train=False)
    h, w = jcfg.height, jcfg.width
    labels = [pose_label(rng, 1, h, w) for _ in range(3)]
    ref_labels = pose_label(rng, 1, h, w)[:, None]
    ref_images = np.tanh(rng.randn(1, 1, h, w, 3)).astype(np.float32)
    jmodels = jstate.build_models(jcfg)
    gshapes = jax.eval_shape(lambda *a: jmodels.netG.init(*a, warp_prev=True, train=False),
                             jax.random.PRNGKey(0), *map(jnp.asarray, (
                                 labels[0], ref_labels, ref_images, labels[1],
                                 ref_images[:, 0])))
    gv = randomize(gshapes, rng)
    _, fv = jax_gf_variables(jcfg, rng)
    split = lambda v: ({k: x for k, x in v.items() if k != "params"}, v["params"])
    (ga, gp), (fa, fp) = split(gv), split(fv)
    jpipe = JaxPipeline(jcfg, jmodels, {"G": gp, "Gf": fp}, {"G": ga, "Gf": fa})
    jpipe.reset(jnp.asarray(ref_labels), jnp.asarray(ref_images), jnp.asarray(labels[0]))
    want = [np.asarray(jpipe.step(jnp.asarray(lbl))["fake_image"]) for lbl in labels]

    g = build_generator(tcfg, device="cpu")
    g.load_state_dict(state_dict_from_jax(to_numpy(gv), tcfg), strict=True)
    pipe = InferencePipeline(tcfg, g, netGf=port_gf(tcfg, fv))
    pipe.reset(ref_labels, ref_images, labels[0])
    got = [pipe.step(lbl)["fake_image"].numpy() for lbl in labels]
    unrefined = InferencePipeline(tcfg.replace(refine_face=False), g)
    unrefined.reset(ref_labels, ref_images, labels[0])
    plain = unrefined.step(labels[0])["fake_image"].numpy()
    assert np.abs(plain - want[0]).max() > 0.05   # the refiner changed the face
    for t, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape == (1, h, w, 3)
        np.testing.assert_allclose(a, b, atol=PIPE_ATOL, err_msg=f"frame {t}")
