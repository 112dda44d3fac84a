"""The port's feature self-similarity (``losses/feature_sim.py``) against
``ssl_tpu``'s on identical numpy inputs (CPU).

``featsim_areaarea`` and ``featsim_channelchannel`` in float64 on both sides
at rtol 1e-9 (the same sums in other orders; float64 leaves ~1e-15).
``PerceptualSimLoss`` with the JAX loss's own random VGG19 weights carried
into the port (``params_from_jax``), every term on, on 32^2 float32 images:
the quadruple at rtol 1e-4 (the VGG19 convolutions sum in other orders, as
tests/test_torch_losses.py holds ``PerceptualLoss``) and d_x within a
relative L2 of 1e-4 with an atol of 1e-6 of its largest element."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.losses import feature_sim as J
from ssl_tpu_torch.losses import feature_sim as T
from ssl_tpu_torch.utils.registry import build_loss
from ssl_tpu_torch.utils.weight_port import params_from_jax

RTOL = 1e-9


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread (the suite runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (dh, dw, kernel_size, softmax, cos_distance, temperature, crossentropy, rearrange_back)
AREA_CASES = [(0, 0, 0, True, False, 0, False, True), (0, 0, 3, False, True, 0.5, False, True),
              (0, 0, 3, True, False, 0, True, False), (4, 4, 3, True, False, 0, False, True),
              (4, 4, 0, True, True, 2.0, False, False), (4, 4, 0, True, False, 0, True, False)]
# (dc, kernel_size, softmax, cos_distance, temperature, crossentropy)
CHANNEL_CASES = [(0, 0, True, False, 0, False), (0, 3, False, True, 0.5, False),
                 (4, 0, True, False, 0, True), (4, 3, True, True, 2.0, False)]


@pytest.mark.parametrize("case", AREA_CASES, ids=[str(i) for i in range(len(AREA_CASES))])
def test_featsim_areaarea_matches_jax(case):
    dh, dw, ks, sm, cos, temp, ce, rb = case
    x = np.random.RandomState(0).rand(2, 3, 8, 8)
    kw = dict(is_shift=True, shift_h=1, shift_w=2, dh=dh, dw=dw, kernel_size=ks, softmax=sm,
              rearrange_back=rb, crossentropy=ce, temperature=temp, cos_distance=cos)
    with jax.enable_x64():
        ref = np.asarray(J.featsim_areaarea(jnp.asarray(x), **kw))
    got = T.featsim_areaarea(torch.from_numpy(x), **kw).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("case", CHANNEL_CASES, ids=[str(i) for i in range(len(CHANNEL_CASES))])
def test_featsim_channelchannel_matches_jax(case):
    dc, ks, sm, cos, temp, ce = case
    x = np.random.RandomState(1).rand(2, 8, 6, 6)
    kw = dict(is_shift=True, shift_c=3, dc=dc, kernel_size=ks, softmax=sm, crossentropy=ce,
              temperature=temp, cos_distance=cos)
    with jax.enable_x64():
        ref = np.asarray(J.featsim_channelchannel(jnp.asarray(x), **kw))
    got = T.featsim_channelchannel(torch.from_numpy(x), **kw).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def test_soft_cross_entropy_and_gram_match_jax():
    rng = np.random.RandomState(2)
    logits, target, f = rng.randn(6, 5), rng.dirichlet(np.ones(5), size=6), rng.rand(2, 4, 3, 5)
    with jax.enable_x64():
        ref = float(J._soft_cross_entropy(jnp.asarray(logits), jnp.asarray(target)))
        ref_g = np.asarray(J._gram(jnp.asarray(f)))
    np.testing.assert_allclose(float(T._soft_cross_entropy(torch.from_numpy(logits),
                                                           torch.from_numpy(target))),
                               ref, rtol=RTOL)
    np.testing.assert_allclose(T._gram(torch.from_numpy(f)).numpy(), ref_g, rtol=RTOL)


def test_perceptual_sim_loss_matches_jax_with_carried_vgg():
    opt = {"type": "PerceptualSimLoss",
           "layer_weights": {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1.0, "conv4_4": 1.0,
                             "conv5_4": 1.0},
           "perceptual_weight": 1.0, "style_weight": 0.5,
           "simself_weight": 0.3, "simself_layer_weights": (0, 0, 1, 1, 1),
           "feat_simself_dh_list": (0, 0, 4, 2, 0), "feat_simself_dw_list": (0, 0, 4, 2, 0),
           "feat_kernel_size_list": (0, 0, 3, 3, 0),
           "simself_channel_weight": 0.2, "simself_channel_layer_wights": (0, 0, 1, 1, 1),
           "criterion_simself_channel": "crossentropy",
           "feat_simself_dc_list": (0, 0, 16, 16, 16),
           "feat_channel_kernel_size_list": (0, 0, 3, 0, 0)}
    from ssl_tpu.losses import build_loss as jax_build_loss
    jloss = jax_build_loss(dict(opt))
    tloss = build_loss(dict(opt))
    assert isinstance(tloss, T.PerceptualSimLoss)
    params = jax.tree_util.tree_map(np.asarray, jloss.variables["params"])
    tloss.vgg.load_state_dict(params_from_jax("VGGFeatureExtractor", params))
    rng = np.random.RandomState(4)
    x, gt = rng.rand(2, 32, 32, 3).astype(np.float32), rng.rand(2, 32, 32, 3).astype(np.float32)

    def f(v):
        terms = jloss(v, jnp.asarray(gt))
        return sum(terms), terms
    (_, ref), ref_d = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(x))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_(True)
    got = tloss(xt, torch.from_numpy(np.ascontiguousarray(gt.transpose(0, 3, 1, 2))))
    sum(got).backward()
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-4)
    d = xt.grad.numpy().transpose(0, 2, 3, 1)
    rd = np.asarray(ref_d)
    err = np.maximum(np.abs(d - rd) - 1e-6 * np.abs(rd).max(), 0)
    assert np.linalg.norm(err) <= 1e-4 * np.linalg.norm(rd)


def test_perceptual_sim_loss_gives_none_for_zero_weights():
    loss = T.PerceptualSimLoss({"conv1_2": 1.0}, perceptual_weight=0.0)
    x = torch.rand(1, 3, 8, 8)
    assert loss(x, x) == (None, None, None, None)
