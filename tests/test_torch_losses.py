"""The port's losses and VGG19 features against the JAX package, on the CPU.

Every loss function takes the same numpy tensors on both sides (NHWC for
JAX, NCHW for the port) and must agree to 1e-5 (means of f32 arithmetic on
values of order one).  The discriminator and the VGG19 behind the assembled
losses carry the same numpy-drawn weights through the converters; VGG taps
agree to 1e-4 (sixteen f32 convolutions summed in another order), and losses
that sum many discriminator or VGG activations to 1e-4 for the same reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.losses import collector as jlc
from fsvid2vid_tpu.losses import gan as jgan
from fsvid2vid_tpu.models.discriminator import (
    MultiscaleDiscriminator as JaxMultiscaleD)
from fsvid2vid_tpu.models.vgg import Vgg19Features as JaxVgg
from fsvid2vid_tpu_torch import config as tconfig
from fsvid2vid_tpu_torch.losses import collector as tlc
from fsvid2vid_tpu_torch.losses import gan as tgan
from fsvid2vid_tpu_torch.models.discriminator import MultiscaleDiscriminator
from fsvid2vid_tpu_torch.models.vgg import VGG_LOSS_TAPS, Vgg19Features
from fsvid2vid_tpu_torch.training.state import build_models
from fsvid2vid_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax, vgg_state_dict_from_jax)
from tests.test_networks import tiny_face_cfg
from tests.test_torch_layers import randomize, to_numpy

ATOL = 1e-5
NET_ATOL = 1e-4
B, H, W = 2, 32, 32


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, -3)))


def close(got, want, atol=ATOL):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(float(got), float(want), atol=atol, rtol=atol)


def preds(rng, num_D=2, n_layers=3):
    """A multiscale discriminator output: per scale a list of activations,
    the last one the logit map, around the hinge's kinks at +-1."""
    return [[(1.5 * rng.randn(B, H >> (i + j), W >> (i + j), 4 if j < n_layers else 1))
             .astype(np.float32) for j in range(n_layers + 1)] for i in range(num_D)]


def both(pred):
    return ([[jnp.asarray(t) for t in p] for p in pred],
            [[nchw(t) for t in p] for p in pred])


@pytest.mark.parametrize("mode,real,for_d", [
    ("hinge", True, True), ("hinge", False, True), ("hinge", True, False),
    ("ls", True, True), ("ls", False, True), ("original", True, True),
    ("original", False, True), ("w", True, True), ("w", False, True)])
def test_gan_loss(rng, mode, real, for_d):
    jp, tp = both(preds(rng))
    close(tgan.gan_loss(tp, real, mode, for_d), jgan.gan_loss(jp, real, mode, for_d))
    # a bare logit map, not wrapped in lists
    close(tgan.gan_loss(tp[0][-1], real, mode, for_d),
          jgan.gan_loss(jp[0][-1], real, mode, for_d))


def test_feature_matching_and_l1_losses(rng):
    (jr, tr), (jf_, tf_) = both(preds(rng)), both(preds(rng))
    close(tgan.feature_matching_loss(tr, tf_, 10.0),
          jgan.feature_matching_loss(jr, jf_, 10.0))
    x, t = (rng.randn(B, H, W, 3).astype(np.float32) for _ in range(2))
    m = rng.rand(B, H, W, 1).astype(np.float32)
    close(tgan.masked_l1_loss(nchw(x), nchw(t), nchw(m)),
          jgan.masked_l1_loss(jnp.asarray(x), jnp.asarray(t), jnp.asarray(m)))
    close(tgan.l1_loss(nchw(x), nchw(t)), jgan.l1_loss(jnp.asarray(x), jnp.asarray(t)))


def test_feature_matching_detaches_the_real_side(rng):
    _, tr = both(preds(rng))
    _, tf_ = both(preds(rng))
    for p in tr + tf_:
        for t in p:
            t.requires_grad_()
    tgan.feature_matching_loss(tr, tf_, 10.0).backward()
    assert all(t.grad is None for p in tr for t in p)
    assert all(t.grad is not None for p in tf_ for t in p[:-1])


def cfgs(**kw):
    cfg = tiny_face_cfg(**kw)
    return cfg, tconfig.Config.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def disc():
    """The JAX image discriminator of the tiny face config at num_D = 2, its
    variables, and the port's with the same weights (eval: u / v stay)."""
    rng = np.random.RandomState(7)
    cfg, tcfg = cfgs(num_D=2)
    jd = JaxMultiscaleD(cfg, cfg.netD_input_nc, cfg.ndf, cfg.n_layers_D,
                        cfg.norm_D, cfg.netD_subarch, cfg.num_D)
    x = jnp.zeros((2 * B, H, W, cfg.netD_input_nc))
    variables = randomize(jax.eval_shape(
        lambda: jd.init(jax.random.PRNGKey(0), x, None, train=True)), rng)
    td = MultiscaleDiscriminator(tcfg.netD_input_nc, tcfg.ndf, tcfg.n_layers_D,
                                 tcfg.norm_D, tcfg.netD_subarch, tcfg.num_D)
    td.load_state_dict(discriminator_state_dict_from_jax(to_numpy(variables)),
                       strict=True)
    japply = lambda x, ref=None: jd.apply(variables, x, ref, train=False)
    return cfg, tcfg, japply, td.eval()


def images(rng, cfg):
    cl = cfg.gen_input_nc
    mk = lambda c: rng.randn(B, H, W, c).astype(np.float32)
    return dict(tgt_label=mk(cl), ref_label=mk(cl), tgt_image=np.tanh(mk(3)),
                fake=np.tanh(mk(3)), raw=np.tanh(mk(3)), ref_image=np.tanh(mk(3)))


@pytest.mark.parametrize("for_d", [True, False])
def test_compute_gan_losses(rng, disc, for_d):
    """[main, raw] pairs through D on fake-then-real batches.  For the
    generator the hinge is the saturating mean(relu(1 - x)) of the reference."""
    cfg, tcfg, japply, td = disc
    im = images(rng, cfg)
    j = lambda k: jnp.asarray(im[k])
    t = lambda k: nchw(im[k])
    want = jlc.compute_gan_losses(
        cfg, {"D": japply}, j("tgt_label"), [j("tgt_image"), j("tgt_image")],
        [j("fake"), j("raw")], j("ref_label"), j("ref_image"), for_d)
    with torch.no_grad():
        got = tlc.compute_gan_losses(
            tcfg, {"D": td}, t("tgt_label"), [t("tgt_image"), t("tgt_image")],
            [t("fake"), t("raw")], t("ref_label"), t("ref_image"), for_d)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        close(g, w, NET_ATOL)
    assert float(got[0]) > 0 and float(got[2]) == float(got[3]) == 0
    if not for_d:
        # the saturating hinge: recompute it from the port's own D output
        x = torch.cat([t("ref_label"), t("ref_image"), t("tgt_label"), t("fake")], 1)
        with torch.no_grad():
            logits = [p[-1] for p in td(x)]
        sat = sum(torch.relu(1 - l).mean() for l in logits) / len(logits)
        x = x.clone()
        x[:, -3:] = t("raw")
        with torch.no_grad():
            logits = [p[-1] for p in td(x)]
        sat = sat + sum(torch.relu(1 - l).mean() for l in logits) / len(logits)
        close(got[0], sat, NET_ATOL)


def test_raw_output_may_be_absent(rng, disc):
    cfg, tcfg, japply, td = disc
    im = images(rng, cfg)
    want = jlc.compute_gan_losses(
        cfg, {"D": japply}, jnp.asarray(im["tgt_label"]),
        [jnp.asarray(im["tgt_image"])] * 2, [jnp.asarray(im["fake"]), None],
        jnp.asarray(im["ref_label"]), jnp.asarray(im["ref_image"]), True)
    with torch.no_grad():
        got = tlc.compute_gan_losses(
            tcfg, {"D": td}, nchw(im["tgt_label"]), [nchw(im["tgt_image"])] * 2,
            [nchw(im["fake"]), None], nchw(im["ref_label"]),
            nchw(im["ref_image"]), True)
    for g, w in zip(got, want):
        close(g, w, NET_ATOL)


@pytest.fixture(scope="module")
def vgg():
    rng = np.random.RandomState(11)
    jv = JaxVgg()
    shapes = jax.eval_shape(lambda: jv.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, H, W, 3))))
    # He-scaled kernels keep the relu activations of order one through 16 layers
    params = jax.tree_util.tree_map(lambda a: a * np.sqrt(2.0).astype(np.float32),
                                    randomize(shapes, rng)["params"])
    tv = Vgg19Features()
    tv.load_state_dict(vgg_state_dict_from_jax(to_numpy(params)), strict=True)
    return (lambda x: jv.apply({"params": params}, x)), tv.eval()


def test_vgg_taps(rng, vgg):
    japply, tv = vgg
    x = np.tanh(rng.randn(B, H, W, 3)).astype(np.float32)
    want = japply(jnp.asarray(x))
    with torch.no_grad():
        got = tv(nchw(x))
    assert len(got) == len(want) == len(VGG_LOSS_TAPS) == 5
    assert [g.shape[1] for g in got] == [64, 128, 256, 512, 512]
    for g, w in zip(got, want):
        assert np.abs(np.asarray(w)).max() > 0.1
        np.testing.assert_allclose(g.movedim(1, -1).numpy(), np.asarray(w),
                                   atol=NET_ATOL)
    keys = list(tv.state_dict())
    assert keys[0] == "features.0.weight" and keys[-1] == "features.28.bias"


@pytest.mark.parametrize("with_raw", [True, False])
def test_compute_vgg_losses(rng, vgg, with_raw):
    japply, tv = vgg
    cfg, tcfg = cfgs()
    im = images(rng, cfg)
    raw = im["raw"] if with_raw else None
    want = jlc.compute_vgg_losses(cfg, japply, jnp.asarray(im["fake"]),
                                  None if raw is None else jnp.asarray(raw),
                                  jnp.asarray(im["tgt_image"]), 1.0)
    fake = nchw(im["fake"]).requires_grad_()
    tgt = nchw(im["tgt_image"]).requires_grad_()
    got = tlc.compute_vgg_losses(tcfg, tv, fake, None if raw is None else nchw(raw),
                                 tgt, 1.0)
    close(got, want, NET_ATOL)
    got.backward()
    assert fake.grad is not None and tgt.grad is None   # the target is detached
    z = tlc.compute_vgg_losses(tcfg.replace(no_vgg_loss=True), tv, fake, None, tgt, 1.0)
    assert float(z) == 0.0


@pytest.mark.parametrize("prev", [False, True])
def test_flow_and_mask_losses(rng, prev):
    cfg, tcfg = cfgs()
    mk = lambda c, s=1.0: (s * rng.randn(B, H, W, c)).astype(np.float32)
    opt = lambda x: x if prev else None
    tgt = np.tanh(mk(3))
    flow = [mk(2, 2.0), opt(mk(2, 2.0))]
    warped = [np.tanh(mk(3)) * 0.3 + 0.7 * tgt, opt(np.tanh(mk(3)))]
    mask = [rng.rand(B, H, W, 1).astype(np.float32), opt(rng.rand(B, H, W, 1).astype(np.float32))]
    flow_gt = [mk(2, 2.0), opt(mk(2, 2.0))]
    conf_gt = [(rng.rand(B, H, W, 1) > 0.5).astype(np.float32),
               opt((rng.rand(B, H, W, 1) > 0.5).astype(np.float32))]
    J = lambda xs: [None if x is None else jnp.asarray(x) for x in xs]
    T = lambda xs: [None if x is None else nchw(x) for x in xs]
    lbl = jnp.zeros((B, H, W, cfg.gen_input_nc))
    wf, ww, _ = jlc.compute_flow_losses(cfg, J(flow), J(warped), jnp.asarray(tgt),
                                        J(flow_gt), J(conf_gt), None, lbl, lbl)
    gf, gw, no_diff = tlc.compute_flow_losses(tcfg, T(flow), T(warped), nchw(tgt),
                                              T(flow_gt), T(conf_gt), None)
    assert no_diff is None   # body-part masks are a pose term
    close(gf, wf)
    close(gw, ww)
    assert float(gf) > 0 and float(gw) > 0
    # without a teacher there is no flow loss, but the warp loss stays
    gf0, gw0, _ = tlc.compute_flow_losses(tcfg, T(flow), T(warped), nchw(tgt),
                                          [None, None], [None, None], None)
    assert float(gf0) == 0.0
    close(gw0, ww)
    wm = jlc.compute_mask_losses(cfg, J(mask), None, J(warped), lbl, jnp.asarray(tgt),
                                 None, None, None, None)
    gm = tlc.compute_mask_losses(tcfg, T(mask), T(warped), nchw(tgt))
    close(gm, wm)
    assert float(gm) > 0


@pytest.mark.parametrize("kw", [dict(netD_subarch="adaptive"), dict(lambda_kld=1.0)])
def test_adaptive_D_and_kld_loss_build(kw):
    """The face D and the pose terms are ported (tests/test_torch_pose_losses.py),
    and so are the KLD loss with the VAE it scores
    (tests/test_torch_kld_concat.py) and the adaptive discriminator
    (tests/test_torch_adaptive_discriminator.py): a face or pose training
    configuration that asks for the adaptive D builds it on netD_input_nc
    channels, which no longer count the reference's (it is D's second
    input), one that asks for the KLD loss builds with the VAE's layers, and
    the same pose configuration without either builds."""
    tiny = dict(ngf=4, ndf=4, fine_size=32, load_size=32, n_downsample_G=3,
                n_adaptive_layers=2, no_vgg_loss=True)
    for preset in (tconfig.face_config, tconfig.pose_config):
        cfg = preset(**tiny, **kw)
        models = build_models(cfg, device="cpu")
        if "lambda_kld" in kw:
            assert {"fc_mu_ref", "fc_var_ref", "fc"} <= {n for n, _ in models.netG.named_children()}
            continue
        d = models.netD.discriminator_0
        assert not cfg.concat_ref_for_D
        assert cfg.netD_input_nc < preset(**tiny).netD_input_nc
        assert d.encoder_0.in_channels == d.fc_0.out_features // 16 == cfg.netD_input_nc
        assert models.netDT.discriminator_0.model0[0].weight.shape[1] == 3 * cfg.tD
    assert build_models(tconfig.pose_config(**tiny), device="cpu").netDf is not None
