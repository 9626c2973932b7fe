"""The port's pose losses against the JAX package's, on the CPU: the
foreground masks appended to the image discriminator's labels, the face
discriminator on face crops (`discriminate_face`, with its L1 and VGG terms
for the generator), and the pose terms of the flow and mask losses
(body-part and foreground warp consistency, the face and disocclusion mask
terms).  Same numpy inputs on both sides (NHWC for JAX, NCHW for the port);
the networks carry the same numpy-drawn weights through the converters.

Tolerances, as tests/test_torch_losses.py: 1e-5 for losses of masks, warps
and images, 1e-4 where the loss sums discriminator or VGG activations (f32
convolutions summed in another order); body_mask_diff to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.config import pose_config as jpose
from fsvid2vid_tpu.losses import collector as jlc
from fsvid2vid_tpu.models import input_process as jip
from fsvid2vid_tpu.models.discriminator import MultiscaleDiscriminator as JaxD
from fsvid2vid_tpu.models.vgg import Vgg19Features as JaxVgg
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.losses import collector as tlc
from fsvid2vid_tpu_torch.models import input_process as tip
from fsvid2vid_tpu_torch.models.discriminator import MultiscaleDiscriminator
from fsvid2vid_tpu_torch.models.vgg import Vgg19Features
from fsvid2vid_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax, vgg_state_dict_from_jax)
from tests.test_torch_layers import randomize, to_numpy

ATOL = 1e-5
NET_ATOL = 1e-4
B, SIZE = 2, 64          # pose: H = 128, W = 64, face crops 32 x 32
KW = dict(fine_size=SIZE, load_size=SIZE, ndf=4, n_layers_D=3)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.array(x), -1, -3)))


def close(got, want, atol=ATOL):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(float(got), float(want), atol=atol, rtol=atol)


def pose_label(rng, b, h, w, shift=0):
    """A raw 6-channel pose label (b, h, w, 6): a body of DensePose parts
    (ids 1-22) on a background of part 0 under a face of parts 23 / 24, and
    random OpenPose channels."""
    part = np.zeros((b, h, w), np.int64)
    fh, fw = max(4, h // 10), max(3, w // 10)
    for i in range(b):
        y0, x0 = h // 8 + fh + shift + i, w // 4 + shift
        part[i, y0:y0 + h // 2, x0:x0 + w // 2] = rng.randint(1, 23, (h // 2, w // 2))
        xc = x0 + w // 4
        part[i, y0 - fh:y0, xc - fw:xc] = 23
        part[i, y0 - fh:y0, xc:xc + fw] = 24
    label = rng.uniform(-1, 1, (b, h, w, 6))
    label[..., 2] = (part / 24 - 0.5) * 2
    return label.astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    """JAX D (pose input with fg masks), the face D and VGG19 with
    numpy-drawn weights, and the port's with the same weights (eval)."""
    rng = np.random.RandomState(3)
    jcfg = jpose(**KW)
    tcfg = tconfig.Config.from_json(jcfg.to_json())
    out = {}
    for key, nc, size in (("D", jcfg.netD_input_nc, (jcfg.height, jcfg.width)),
                          ("Df", 2 * jcfg.output_nc, (32, 32))):
        jd = JaxD(jcfg, nc, jcfg.ndf, jcfg.n_layers_D, jcfg.norm_D, "n_layers", 1)
        x = jnp.zeros((2 * B, *size, nc))
        v = randomize(jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0), x, None,
                                                     train=True)), rng)
        td = MultiscaleDiscriminator(nc, tcfg.ndf, tcfg.n_layers_D, tcfg.norm_D,
                                     "n_layers", 1)
        td.load_state_dict(discriminator_state_dict_from_jax(to_numpy(v)), strict=True)
        out[key] = ((lambda x, ref=None, jd=jd, v=v: jd.apply(v, x, ref, train=False)),
                    td.eval())
    jv = JaxVgg()
    shapes = jax.eval_shape(lambda: jv.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    params = jax.tree_util.tree_map(lambda a: a * np.sqrt(2.0).astype(np.float32),
                                    randomize(shapes, rng)["params"])
    tv = Vgg19Features()
    tv.load_state_dict(vgg_state_dict_from_jax(to_numpy(params)), strict=True)
    out["vgg"] = (lambda x: jv.apply({"params": params}, x)), tv.eval()
    return jcfg, tcfg, out


def inputs(rng, cfg):
    h, w = cfg.height, cfg.width
    img = lambda: np.tanh(rng.randn(B, h, w, 3)).astype(np.float32)
    return dict(tgt_label=pose_label(rng, B, h, w), ref_label=pose_label(rng, B, h, w, shift=5),
                tgt_image=img(), fake=img(), raw=img(), ref_image=img())


@pytest.mark.parametrize("for_d", [True, False])
@pytest.mark.parametrize("face_d", [True, False])
def test_pose_gan_losses(nets, for_d, face_d):
    """[main, raw] pairs through D with the foreground masks appended to the
    target's valid label and to the reference's raw label, plus the face D on
    the face crops: its GAN terms times lambda_face, and for G the L1 and
    VGG of the crops."""
    jcfg, tcfg, n = nets
    jcfg, tcfg = (c.replace(add_face_D=face_d) for c in (jcfg, tcfg))
    im = inputs(np.random.RandomState(5), jcfg)
    j = lambda k: jnp.asarray(im[k])
    t = lambda k: nchw(im[k])
    japplies = {k: n[k][0] for k in ("D", "Df", "vgg")}
    tapplies = {k: n[k][1] for k in ("D", "Df", "vgg")}
    want = jlc.compute_gan_losses(
        jcfg, japplies, j("tgt_label"), [j("tgt_image"), j("tgt_image")],
        [j("fake"), j("raw")], j("ref_label"), j("ref_image"), for_d)
    valid = nchw(jip.use_valid_labels(jcfg, j("tgt_label")))
    with torch.no_grad():
        got = tlc.compute_gan_losses(
            tcfg, tapplies, valid, [t("tgt_image"), t("tgt_image")],
            [t("fake"), t("raw")], t("ref_label"), t("ref_image"), for_d,
            tgt_label_raw=t("tgt_label"))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        close(g, w, NET_ATOL)
    assert float(got[0]) > 0
    assert (float(got[2]) > 0) == face_d and (float(got[3]) > 0) == face_d
    with pytest.raises(ValueError, match="raw target label"):
        tlc.compute_gan_losses(tcfg, tapplies, valid, t("tgt_image"), t("fake"),
                               t("ref_label"), t("ref_image"), for_d)


def test_discriminate_face_alone(nets):
    """The face terms by themselves; the generator's include the crops' L1
    times lambda_feat and VGG times lambda_vgg, with and without VGG."""
    jcfg, tcfg, n = nets
    im = inputs(np.random.RandomState(6), jcfg)
    j = lambda k: jnp.asarray(im[k])
    t = lambda k: nchw(im[k])
    for no_vgg in (False, True):
        jc, tc = jcfg.replace(no_vgg_loss=no_vgg), tcfg.replace(no_vgg_loss=no_vgg)
        for for_d in (True, False):
            want = jlc.discriminate_face(jc, n["Df"][0], n["vgg"][0], j("fake"),
                                         j("tgt_label"), j("tgt_image"), j("ref_label"),
                                         j("ref_image"), for_d)
            fake = t("fake").requires_grad_()
            got = tlc.discriminate_face(tc, n["Df"][1], n["vgg"][1], fake, t("tgt_label"),
                                        t("tgt_image"), t("ref_label"), t("ref_image"), for_d)
            for g, w in zip(got, want):
                close(g, w, NET_ATOL)
            if not for_d:
                got[1].backward()   # the face crop's gradient reaches the image
                assert float(fake.grad.abs().sum()) > 0


@pytest.mark.parametrize("prev", [False, True])
def test_pose_flow_and_mask_losses(nets, prev):
    jcfg, tcfg, _ = nets
    rng = np.random.RandomState(9)
    h, w = jcfg.height, jcfg.width
    mk = lambda c, s=1.0: (s * rng.randn(B, h, w, c)).astype(np.float32)
    opt = lambda x: x if prev else None
    im = inputs(rng, jcfg)
    tgt, fake = im["tgt_image"], im["fake"]
    flow = [mk(2, 3.0), opt(mk(2, 2.0))]
    warped = [np.tanh(mk(3)) * 0.3 + 0.7 * tgt, opt(np.tanh(mk(3)))]
    mask = [rng.rand(B, h, w, 1).astype(np.float32),
            opt(rng.rand(B, h, w, 1).astype(np.float32))]
    flow_gt = [mk(2, 2.0), opt(mk(2, 2.0))]
    conf_gt = [(rng.rand(B, h, w, 1) > 0.5).astype(np.float32),
               opt((rng.rand(B, h, w, 1) > 0.5).astype(np.float32))]
    J = lambda xs: [None if x is None else jnp.asarray(x) for x in xs]
    T = lambda xs: [None if x is None else nchw(x) for x in xs]
    jl, jr = jnp.asarray(im["tgt_label"]), jnp.asarray(im["ref_label"])
    tl, tr = nchw(im["tgt_label"]), nchw(im["ref_label"])
    jfg, jrfg = jip.get_fg_mask(jcfg, jl), jip.get_fg_mask(jcfg, jr)
    tfg = nchw(tip.get_fg_mask(tcfg, torch.from_numpy(im["tgt_label"])))
    trfg = nchw(tip.get_fg_mask(tcfg, torch.from_numpy(im["ref_label"])))
    np.testing.assert_array_equal(tfg.numpy(), nchw(jfg).numpy())
    assert 0 < float(tfg.mean()) < 1

    wf, ww, wdiff = jlc.compute_flow_losses(jcfg, J(flow), J(warped), jnp.asarray(tgt),
                                            J(flow_gt), J(conf_gt), jfg, jl, jr)
    gf, gw, gdiff = tlc.compute_flow_losses(tcfg, T(flow), T(warped), nchw(tgt),
                                            T(flow_gt), T(conf_gt), tfg, tl, tr)
    close(gf, wf)
    close(gw, ww)
    np.testing.assert_allclose(gdiff.numpy(), nchw(wdiff).numpy(), atol=ATOL)
    assert gdiff.shape == (B, 1, h, w) and float(gdiff.max()) > 0
    # the pose terms are in: the warp loss exceeds the image-only one
    _, gw_face, none = tlc.compute_flow_losses(tcfg.replace(dataset_mode="fewshot_face"),
                                               T(flow), T(warped), nchw(tgt), T(flow_gt),
                                               T(conf_gt), tfg, tl, tr)
    assert none is None and float(gw) > float(gw_face)

    wm = jlc.compute_mask_losses(jcfg, J(mask), jnp.asarray(fake), J(warped), jl,
                                 jnp.asarray(tgt), None, jfg, jrfg, wdiff)
    fake_t = nchw(fake).requires_grad_()
    warped_t = T(warped)
    warped_t[0].requires_grad_()
    gm = tlc.compute_mask_losses(tcfg, T(mask), warped_t, nchw(tgt), fake_t, tl, tfg,
                                 trfg, gdiff)
    close(gm, wm)
    gm.backward()
    # the synthesized face is pulled to the warped reference, not the reverse
    assert float(fake_t.grad.abs().sum()) > 0
    no_sc = tlc.compute_mask_losses(tcfg.replace(spade_combine=False), T(mask), T(warped),
                                    nchw(tgt), nchw(fake), tl, tfg, trfg, gdiff)
    close(no_sc, jlc.compute_mask_losses(jcfg.replace(spade_combine=False), J(mask),
                                         jnp.asarray(fake), J(warped), jl, jnp.asarray(tgt),
                                         None, jfg, jrfg, wdiff))
    assert float(no_sc) < float(gm.detach())
