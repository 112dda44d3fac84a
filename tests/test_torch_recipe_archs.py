"""The six bicubic GAN-SSL recipes' archs in the port against ssl_tpu's, on
identical weights and inputs (fp32, CPU, no TF32 on this device).

Weights are each JAX module's own random init, carried into the port with
``params_from_jax``.  Tolerance: every output within rtol 1e-5 and atol 1e-5
(the outputs are O(1): SR images, logits, Ranker scores).  The two
frameworks sum convolutions and products in other orders, so they agree to
float32 rounding, amplified by depth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.archs.bsrgan_arch import BSRGANRRDBNet as JBSRGAN, RRDBBebyGANNet as JBebyGAN
from ssl_tpu.archs.elan_arch import ELAN as JELAN
from ssl_tpu.archs.ranksrgan_arch import (Discriminator_VGG_296 as JD296,
                                          RankSRGANSRResNet as JRankG,
                                          Ranker_VGG12_296 as JRanker)
from ssl_tpu.archs.spsr_arch import SPSRNet as JSPSR
from ssl_tpu.archs.swinir_arch import SwinIR as JSwinIR
from ssl_tpu_torch.archs import (ELAN, BSRGANRRDBNet, Discriminator_VGG_296, RankSRGANSRResNet,
                                 Ranker_VGG12_296, RRDBBebyGANNet, SPSRNet, SwinIR)
from ssl_tpu_torch.utils.weight_port import params_from_jax

RTOL = ATOL = 1e-5

SWIN = dict(embed_dim=12, window_size=4, img_size=16)
# name: (JAX module, port module, (h, w) of the input)
CASES = {
    "RRDBBebyGANNet": (JBebyGAN(nf=8, nb=2, gc=4), RRDBBebyGANNet(nf=8, nb=2, gc=4), (6, 5)),
    "BSRGANRRDBNet_x2": (JBSRGAN(nf=8, nb=1, gc=4, sf=2), BSRGANRRDBNet(nf=8, nb=1, gc=4, sf=2),
                         (6, 5)),
    "SPSRNet": (JSPSR(nf=8, nb=23), SPSRNet(nf=8, nb=23), (6, 7)),
    "RankSRGANSRResNet": (JRankG(nf=8, nb=2), RankSRGANSRResNet(nf=8, nb=2), (6, 5)),
    "Discriminator_VGG_296": (JD296(nf=4), Discriminator_VGG_296(nf=4, input_size=64), (64, 64)),
    "Ranker_VGG12_296": (JRanker(nf=4), Ranker_VGG12_296(nf=4), (64, 48)),
    # a pad as long as the input: the LQ is one window wide
    "SwinIR_lq4": (JSwinIR(depths=(2, 2), num_heads=(2, 2), **SWIN),
                   SwinIR(depths=(2, 2), num_heads=(2, 2), **SWIN), (4, 4)),
    "SwinIR_10x14": (JSwinIR(depths=(2, 2), num_heads=(2, 2), **SWIN),
                     SwinIR(depths=(2, 2), num_heads=(2, 2), **SWIN), (10, 14)),
    # depth 4: the JAX blocks run as 2 scanned (no-shift, shift) pairs
    "SwinIR_pairs": (JSwinIR(depths=(4,), num_heads=(3,), **SWIN),
                     SwinIR(depths=(4,), num_heads=(3,), **SWIN), (10, 14)),
    "ELAN_10x14": (JELAN(m_elan=2, c_elan=30), ELAN(m_elan=2, c_elan=30), (10, 14)),
    # n_share 1: the second GMSA of the ELAB reuses the first one's maps
    "ELAN_shared": (JELAN(m_elan=2, c_elan=30, n_share=1), ELAN(m_elan=2, c_elan=30, n_share=1),
                    (16, 16)),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("name", sorted(CASES))
def test_recipe_arch_forward_matches_jax(name):
    """Forward of each arch: the discriminator in train mode (batch
    statistics, then its running statistics), the Ranker in eval mode with
    non-trivial running statistics, SPSR's three outputs."""
    jnet, net, (h, w) = CASES[name]
    family = type(net).__name__
    rng = np.random.RandomState(sum(map(ord, name)))
    x = rng.rand(2, h, w, 3).astype(np.float32)
    variables = _np(jnet.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    stats = variables.get("batch_stats")
    if name == "Ranker_VGG12_296":          # running statistics away from (0, 1)
        stats = jax.tree_util.tree_map(
            lambda a: (a + rng.rand(*a.shape).astype(np.float32) * 0.5), stats)
        variables["batch_stats"] = stats
    sd = params_from_jax(family, variables["params"], stats)
    missing, unexpected = net.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    if name == "Discriminator_VGG_296":
        ref, new_vars = jnet.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
        net.train()
        with torch.no_grad():
            got = net(xt)
        new_sd = params_from_jax(family, variables["params"], _np(new_vars["batch_stats"]))
        for k, v in new_sd.items():
            if "running" in k:
                np.testing.assert_allclose(net.state_dict()[k].numpy(), v.numpy(),
                                           rtol=RTOL, atol=ATOL, err_msg=k)
        outs = [(got, ref)]
    else:
        args = (False,) if name.startswith("Ranker") else ()
        ref = jnet.apply(variables, jnp.asarray(x), *args)
        net.eval()
        with torch.no_grad():
            got = net(xt)
        outs = list(zip(got, ref)) if name == "SPSRNet" else [(got, ref)]
    for g, r in outs:
        g = g.numpy()
        r = np.asarray(r)
        if g.ndim == 4:
            g = g.transpose(0, 2, 3, 1)
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)


def test_swinir_symmetric_pad_and_elan_shift_match_numpy():
    """The two index tricks alone: ``pad_symmetric`` equals ``np.pad``'s
    "symmetric" mode up to a pad of twice the axis, and ``shift_channels``
    equals the JAX rolls with zeroed borders (c = 23: the remainder of c // 5
    joins the unshifted group)."""
    from ssl_tpu.archs.elan_arch import shift_channels as jshift
    from ssl_tpu_torch.archs.arch_util import pad_symmetric
    from ssl_tpu_torch.archs.elan_arch import shift_channels
    x = np.random.RandomState(0).rand(1, 2, 3, 5).astype(np.float32)
    for ph, pw in ((0, 0), (3, 5), (6, 10)):
        want = np.pad(x, ((0, 0), (0, 0), (0, ph), (0, pw)), mode="symmetric")
        np.testing.assert_array_equal(pad_symmetric(torch.from_numpy(x), ph, pw).numpy(), want)
    y = np.random.RandomState(1).rand(2, 5, 6, 23).astype(np.float32)
    np.testing.assert_array_equal(shift_channels(torch.from_numpy(y)).numpy(),
                                  np.asarray(jshift(jnp.asarray(y))))


def test_elan_full_width_init_keeps_its_output_in_range():
    """At the shipped width (36 ELABs x 180) the port's own init (torch's
    default variance, 1 / (3 fan_in)) gives an SR of a [0, 1] input with a
    standard deviation under 1, where flax's lecun variance (1 / fan_in),
    which the JAX module draws, compounds past 100."""
    from ssl_tpu_torch.archs.arch_util import normal_init_
    x = torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    net = ELAN()
    net.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        own = net(x)
        normal_init_(net, torch.Generator().manual_seed(0))
        lecun = net(x)
    print(f"ELAN SR std: own init {float(own.std()):.4g}, lecun {float(lecun.std()):.4g}")
    assert float(own.std()) < 1.0 < 100.0 < float(lecun.std())
