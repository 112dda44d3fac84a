"""The recipes' loss helpers in the port against ssl_tpu's (fp32, CPU):
BebyGAN's resizes, best-buddy pairs and back-projection, LDL's artifact map
and SPSR's image gradient, on the same seeded numpy inputs (NHWC for JAX,
NCHW for the port).

Tolerances: values rtol 1e-5 with an atol of 1e-6 (1e-5 for the artifact
map, a variance of sums); gradients rtol 1e-4 with an atol of 1e-4 of the
largest component.  The best-buddy inputs are continuous random images, on
which no two candidate distances come within rounding of each other, so
both frameworks pick the same buddies and the loss is held itself."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.archs.spsr_arch import image_gradient as j_image_gradient
from ssl_tpu.losses.bbl import back_projection_loss as j_bp, best_buddy_pairs as j_bbp
from ssl_tpu.losses.loss_util import get_refined_artifact_map as j_artifact_map
from ssl_tpu.ops.torch_resize import bebygan_imresize_down as j_down, interp_bicubic as j_bicubic
from ssl_tpu_torch.archs.spsr_arch import image_gradient
from ssl_tpu_torch.losses.bbl import back_projection_loss, best_buddy_pairs
from ssl_tpu_torch.losses.loss_util import get_refined_artifact_map
from ssl_tpu_torch.ops.torch_resize import bebygan_imresize_down, interp_bicubic


def _img(seed, b, h, w):
    return np.random.RandomState(seed).rand(b, h, w, 3).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy()).requires_grad_(grad)


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _close_grad(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(_nhwc(got), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("size", [(12, 7), (5, 9), (40, 40)])
def test_interp_bicubic_matches_jax(size):
    x = _img(0, 2, 24, 18)
    np.testing.assert_allclose(_nhwc(interp_bicubic(_t(x), size)),
                               np.asarray(j_bicubic(jnp.asarray(x), size)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_bebygan_imresize_down_matches_jax(factor):
    """Even and odd factors (the odd kernel drops a tap) on a non-square image."""
    x = _img(1, 2, 12 * factor, 8 * factor)
    np.testing.assert_allclose(_nhwc(bebygan_imresize_down(_t(x), factor)),
                               np.asarray(j_down(jnp.asarray(x), factor)), rtol=1e-5, atol=1e-6)


def test_best_buddy_loss_and_gradient_match_jax():
    """The L1 between SR patches and their buddies (alpha 1, beta 1, 3x3,
    stride 3, as shipped; and alpha 0.5, beta 2), and its gradient in SR."""
    sr, gt = _img(2, 2, 24, 30), _img(3, 2, 24, 30)
    for alpha, beta in ((1.0, 1.0), (0.5, 2.0)):
        def jloss(s):
            p1, sel = j_bbp(s, jnp.asarray(gt), alpha, beta, 3, 3)
            return jnp.mean(jnp.abs(p1 - sel))
        ref, ref_g = jax.value_and_grad(jloss)(jnp.asarray(sr))
        s = _t(sr, grad=True)
        p1, sel = best_buddy_pairs(s, _t(gt), alpha, beta, 3, 3)
        loss = torch.mean(torch.abs(p1 - sel))
        loss.backward()
        assert not sel.requires_grad
        np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
        _close_grad(s.grad, ref_g)


def test_back_projection_loss_and_gradient_match_jax():
    sr, lq = _img(4, 2, 32, 24), _img(5, 2, 8, 6)
    ref, ref_g = jax.value_and_grad(lambda s: j_bp(s, jnp.asarray(lq)))(jnp.asarray(sr))
    s = _t(sr, grad=True)
    loss = back_projection_loss(s, _t(lq))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    _close_grad(s.grad, ref_g)


@pytest.mark.parametrize("ksize", [7, 3])
def test_refined_artifact_map_matches_jax(ksize):
    """The map where the EMA is better at some pixels and worse at others."""
    gt = _img(6, 2, 20, 16)
    rng = np.random.RandomState(7)
    sr = (gt + rng.randn(*gt.shape) * 0.1).astype(np.float32)
    ema = (gt + rng.randn(*gt.shape) * 0.1).astype(np.float32)
    ref = np.asarray(j_artifact_map(jnp.asarray(gt), jnp.asarray(sr), jnp.asarray(ema), ksize))
    got = _nhwc(get_refined_artifact_map(_t(gt), _t(sr), _t(ema), ksize))
    assert 0 < (ref == 0).mean() < 1
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_image_gradient_and_its_gradient_match_jax():
    x = _img(8, 2, 9, 11)
    ref, vjp = jax.vjp(j_image_gradient, jnp.asarray(x))
    cot = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    t = _t(x, grad=True)
    got = image_gradient(t)
    got.backward(_t(cot))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-5, atol=1e-6)
    _close_grad(t.grad, vjp(jnp.asarray(cot))[0])
