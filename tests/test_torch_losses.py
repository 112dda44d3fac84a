"""The port's losses against ssl_tpu's on identical numpy inputs (fp32, CPU).

The JAX package works in NHWC, the port in NCHW: inputs are transposed on
the way in.  Tolerances: elementwise losses and means rtol 1e-6 (the same
float32 arithmetic, summed in another order); the SSL loss rel 1e-4 / 1e-3
for its L1 / KL terms (tests/test_ssg_pallas.py:30-31); the perceptual loss
rtol 1e-4 (VGG19's 16 convolutions summed in another order)."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ssl_tpu.losses import basic_loss as jbasic
from ssl_tpu.losses import gan_loss as jgan
from ssl_tpu_torch.losses import GANLoss, KLDistanceLoss, L1Loss, PerceptualLoss
from ssl_tpu_torch.utils.registry import build_loss
from ssl_tpu_torch.utils.weight_port import params_from_jax

# the packages re-export the function ssl_loss, which shadows the module name
jssl = importlib.import_module("ssl_tpu.losses.ssl_loss")
tssl = importlib.import_module("ssl_tpu_torch.losses.ssl_loss")

SHIPPED_YML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "options", "train", "ESRGANSSL", "train_ESRGANSSL_bicubic_x4.yml")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_l1_loss_matches_jax(reduction):
    rng = np.random.RandomState(0)
    a, b = rng.rand(2, 9, 7, 3).astype(np.float32), rng.rand(2, 9, 7, 3).astype(np.float32)
    ref = jbasic.L1Loss(loss_weight=0.3, reduction=reduction)(jnp.asarray(a), jnp.asarray(b))
    got = L1Loss(loss_weight=0.3, reduction=reduction)(_nchw(a), _nchw(b))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("softmax", [False, True])
def test_kl_distance_loss_matches_jax(softmax):
    rng = np.random.RandomState(1)
    x = rng.dirichlet(np.ones(81), size=40).astype(np.float32)
    y = rng.dirichlet(np.ones(81), size=40).astype(np.float32)
    x[0, :5] = 0.0                                     # exercise the 1e-10 clamp
    ref = jbasic.KLDistanceLoss(loss_weight=1e3, softmax=softmax)(jnp.asarray(x), jnp.asarray(y))
    got = KLDistanceLoss(loss_weight=1e3, softmax=softmax)(torch.from_numpy(x),
                                                           torch.from_numpy(y))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "wgan", "wgan_softplus", "hinge"])
@pytest.mark.parametrize("is_disc", [False, True])
def test_gan_loss_matches_jax(gan_type, is_disc):
    """Both targets; vanilla is BCE-with-logits, and a D loss carries no
    loss_weight (ssl_tpu/losses/gan_loss.py:46)."""
    x = (np.random.RandomState(2).randn(4, 1) * 3).astype(np.float32)
    jl = jgan.GANLoss(gan_type=gan_type, loss_weight=5e-3)
    tl = GANLoss(gan_type=gan_type, loss_weight=5e-3)
    for real in (True, False):
        ref = jl(jnp.asarray(x), real, is_disc=is_disc)
        got = tl(torch.from_numpy(x), real, is_disc=is_disc)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=1e-9)


def test_ssl_setting_from_shipped_yaml_matches_jax():
    with open(SHIPPED_YML) as f:
        opt = yaml.safe_load(f)
    ref = jssl.ssl_setting_from_opt(opt, gt_size=128)
    got = tssl.ssl_setting_from_opt(opt)
    # the port's SSGConfig leaves out pair_offsets (an exact re-ordering in JAX)
    assert tuple(got.ssg) == tuple(getattr(ref.ssg, f) for f in got.ssg._fields)
    for field in got._fields[1:]:
        assert getattr(got, field) == getattr(ref, field), field
    # the shipped GAN tree defines mask_stride but does not apply it
    assert got.mask_stride == 0 and got.impl == "dense"
    forced = dict(opt, ssl_setting=dict(opt["ssl_setting"], apply_mask_stride=True))
    assert tssl.ssl_setting_from_opt(forced).mask_stride == 3


@pytest.mark.parametrize("mask_stride", [0, 3])
def test_ssl_loss_matches_jax_at_shipped_setting(mask_stride):
    """ssl_loss at the shipped search 25 / window 9 / sigma 0.004 on a 32^2
    pair, mask given as (b, h, w, 1) to JAX and (b, 1, h, w) to the port."""
    with open(SHIPPED_YML) as f:
        opt = yaml.safe_load(f)
    opt["train"]["mask_stride"] = mask_stride
    rng = np.random.RandomState(3)
    yy, xx = np.mgrid[0:32, 0:32] / 32
    gt = (np.stack([np.sin(6 * yy) + np.cos(5 * xx), yy * xx, np.cos(8 * (yy + xx))], -1)
          * 0.3 + 0.5)[None].astype(np.float32)
    sr = (gt + rng.randn(*gt.shape) * 0.1).astype(np.float32)
    mask = (rng.rand(1, 32, 32, 1) < 0.3).astype(np.float32)
    ref = jssl.ssl_loss(jnp.asarray(sr), jnp.asarray(gt), jnp.asarray(mask),
                        jssl.ssl_setting_from_opt(opt, gt_size=128))
    got = tssl.ssl_loss(_nchw(sr), _nchw(gt), _nchw(mask), tssl.ssl_setting_from_opt(opt))
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-4)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-3)


@pytest.mark.parametrize("change", [{"impl": "scan"}, {"simself_strategy": "areaarea"}])
def test_ssl_loss_unported_paths_raise(change):
    setting = tssl.ssl_setting_from_opt({"ssl_setting": change,
                                         "train": {"selfsim_opt": {"loss_weight": 1.0}}})
    x = torch.zeros(1, 3, 16, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tssl.ssl_loss(x, x, torch.zeros(1, 16, 16), setting)


def test_ssl_loss_kl_softmax_raises():
    setting = tssl.ssl_setting_from_opt(
        {"ssl_setting": {}, "train": {"selfsim1_opt": {"loss_weight": 1.0, "softmax": True}}})
    x = torch.zeros(1, 3, 16, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tssl.ssl_loss(x, x, torch.zeros(1, 16, 16), setting)


def test_perceptual_loss_matches_jax_with_carried_vgg():
    """conv5_4 (before ReLU) L1 on 32^2 inputs, the JAX loss's own random
    VGG19 weights carried into the port."""
    popt = {"type": "PerceptualLoss", "layer_weights": {"conv5_4": 1}, "vgg_type": "vgg19",
            "use_input_norm": True, "range_norm": False, "perceptual_weight": 1.0,
            "style_weight": 0, "criterion": "l1"}
    from ssl_tpu.losses import build_loss as jax_build_loss
    jloss = jax_build_loss(dict(popt))
    tloss = build_loss(dict(popt))
    assert isinstance(tloss, PerceptualLoss)
    params = jax.tree_util.tree_map(np.asarray, jloss.variables["params"])
    tloss.vgg.load_state_dict(params_from_jax("VGGFeatureExtractor", params))
    rng = np.random.RandomState(4)
    x, gt = rng.rand(2, 32, 32, 3).astype(np.float32), rng.rand(2, 32, 32, 3).astype(np.float32)
    ref, _ = jloss(jnp.asarray(x), jnp.asarray(gt))
    got, style = tloss(_nchw(x), _nchw(gt))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-4)
    assert float(style) == 0.0
