"""The archs the KAIR options reach, and the rest of the GAN tree's
registry (MSRResNet, SRVGGNetCompact, EDSR, RCAN, ECBSR), in the port
against ssl_tpu's, on identical weights and inputs (fp32, CPU).

Weights are each JAX module's own random init, carried into the port with
``params_from_jax``.  Tolerance: rtol and atol (of the largest value of
each output) 1e-5 for the generators, 1e-4 for the discriminators: the two
frameworks sum convolutions in other orders, and batch norms over two
samples amplify that rounding with depth (VGG192's second train-mode logit
of 0.55: JAX 2.6e-5 from a float64 run of the port's module, the port's own
float32 run 4.0e-6).
The discriminators run two train-mode calls (batch statistics; their
running statistics and spectral-norm vectors compared after each) and one
eval-mode call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.archs import classic_sr_archs as jclassic
from ssl_tpu.archs import kair_extra_arch as jkair
from ssl_tpu.archs.srresnet_arch import MSRResNet as JMSRResNet
from ssl_tpu.archs.srvgg_arch import SRVGGNetCompact as JSRVGG
from ssl_tpu_torch import archs
from ssl_tpu_torch.utils.registry import build_network
from ssl_tpu_torch.utils.weight_port import params_from_jax

RTOL, D_RTOL = 1e-5, 1e-4

# name: (JAX module, port module, (h, w) of the input)
G_CASES = {
    "MSRResNet_x4": (JMSRResNet(num_feat=8, num_block=2), archs.MSRResNet(num_feat=8, num_block=2),
                     (6, 5)),
    "MSRResNet_x3": (JMSRResNet(num_feat=8, num_block=1, upscale=3),
                     archs.MSRResNet(num_feat=8, num_block=1, upscale=3), (5, 7)),
    "KAIRMSRResNet0_x4": (jkair.KAIRMSRResNet0(nc=8, nb=2), archs.KAIRMSRResNet0(nc=8, nb=2),
                          (6, 5)),
    "KAIRMSRResNet0_x3": (jkair.KAIRMSRResNet0(nc=8, nb=1, upscale=3),
                          archs.KAIRMSRResNet0(nc=8, nb=1, upscale=3), (5, 4)),
    "SRVGGNetCompact_prelu": (JSRVGG(num_feat=8, num_conv=3), archs.SRVGGNetCompact(
        num_feat=8, num_conv=3), (6, 5)),
    "SRVGGNetCompact_relu_x2": (JSRVGG(num_feat=8, num_conv=2, upscale=2, act_type="relu"),
                                archs.SRVGGNetCompact(num_feat=8, num_conv=2, upscale=2,
                                                      act_type="relu"), (6, 5)),
    "EDSR": (jclassic.EDSR(num_feat=8, num_block=2, res_scale=0.5),
             archs.EDSR(num_feat=8, num_block=2, res_scale=0.5), (6, 5)),
    "EDSR_x3": (jclassic.EDSR(num_feat=8, num_block=1, upscale=3),
                archs.EDSR(num_feat=8, num_block=1, upscale=3), (5, 4)),
    "RCAN": (jclassic.RCAN(num_feat=16, num_group=2, num_block=2, squeeze_factor=4),
             archs.RCAN(num_feat=16, num_group=2, num_block=2, squeeze_factor=4), (6, 5)),
    "ECBSR": (jclassic.ECBSR(num_block=2, num_channel=8), archs.ECBSR(num_block=2, num_channel=8),
              (6, 5)),
    "ECBSR_idt_relu": (jclassic.ECBSR(num_block=1, num_channel=8, with_idt=True, act_type="relu",
                                      scale=2),
                       archs.ECBSR(num_block=1, num_channel=8, with_idt=True, act_type="relu",
                                   scale=2), (5, 6)),
}

D_CASES = {
    "KAIRDiscriminatorVGG96": (jkair.KAIRDiscriminatorVGG96(base_nc=4),
                               archs.KAIRDiscriminatorVGG96(base_nc=4), 96),
    "KAIRDiscriminatorVGG128": (jkair.KAIRDiscriminatorVGG128(base_nc=4),
                                archs.KAIRDiscriminatorVGG128(base_nc=4), 128),
    "KAIRDiscriminatorVGG192": (jkair.KAIRDiscriminatorVGG192(base_nc=4),
                                archs.KAIRDiscriminatorVGG192(base_nc=4), 192),
    "KAIRDiscriminatorVGG128SN": (jkair.KAIRDiscriminatorVGG128SN(),
                                  archs.KAIRDiscriminatorVGG128SN(), 128),
    **{f"KAIRDiscriminatorPatchGAN_{n}": (jkair.KAIRDiscriminatorPatchGAN(ndf=4, norm_type=n),
                                          archs.KAIRDiscriminatorPatchGAN(ndf=4, norm_type=n), 40)
       for n in ("spectral", "batch", "instance", "batchspectral", "instancespectral")},
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, msg="", rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30), err_msg=msg)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _load(net, family, variables):
    sd = params_from_jax(family, variables["params"], variables.get("batch_stats"))
    missing, unexpected = net.load_state_dict(sd, strict=False)
    assert not unexpected, unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing


@pytest.mark.parametrize("name", sorted(G_CASES))
def test_generator_forward_matches_jax(name):
    jnet, net, (h, w) = G_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    x = rng.rand(2, h, w, 3).astype(np.float32)
    variables = _np(jnet.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    if name.startswith("ECBSR"):            # the edge branches' scales away from ~1e-3
        variables = jax.tree_util.tree_map_with_path(
            lambda p, a: a * 300 if str(p[-1].key) == "scale" else a, variables)
    _load(net, type(net).__name__, variables)
    net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    _close(_nhwc(got), jnet.apply(variables, jnp.asarray(x)), name)


@pytest.mark.parametrize("name", sorted(D_CASES))
def test_discriminator_matches_jax(name):
    jnet, net, size = D_CASES[name]
    family = type(net).__name__
    rng = np.random.RandomState(sum(map(ord, name)))
    xs = [rng.rand(2, size, size, 3).astype(np.float32) for _ in range(3)]
    variables = _np(jnet.init(jax.random.PRNGKey(2), jnp.asarray(xs[0])))
    params, stats = variables["params"], variables.get("batch_stats")
    _load(net, family, variables)
    net.train()
    for x in xs[:2]:
        want, new = jnet.apply({"params": params, **({"batch_stats": stats} if stats else {})},
                               jnp.asarray(x), True, mutable=["batch_stats"])
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        _close(_nhwc(got) if got.dim() == 4 else got, want, name, D_RTOL)
        if stats:
            stats = _np(new["batch_stats"])
            ref = params_from_jax(family, params, stats)
            for k, v in net.state_dict().items():
                if k.endswith((".u", ".sigma", "running_mean", "running_var")):
                    _close(v, ref[k].numpy(), k, D_RTOL)
    net.eval()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    want = jnet.apply({"params": params, **({"batch_stats": stats} if stats else {})},
                      jnp.asarray(xs[2]), False)
    got = net(torch.from_numpy(xs[2].transpose(0, 3, 1, 2).copy()))
    _close(_nhwc(got) if got.dim() == 4 else got, want, name, D_RTOL)
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())


@pytest.mark.parametrize("net_opt", [
    {"type": "MSRResNet", "num_feat": 8, "num_block": 1, "upscale": 4},
    {"type": "KAIRMSRResNet0", "nc": 8, "nb": 1, "upscale": 4},
    {"type": "SRVGGNetCompact", "num_feat": 8, "num_conv": 2},
    {"type": "EDSR", "num_feat": 8, "num_block": 1},
    {"type": "RCAN", "num_feat": 16, "num_group": 1, "num_block": 1},
    {"type": "ECBSR", "num_block": 1, "num_channel": 8},
])
def test_generators_train_from_their_own_init(net_opt):
    """Built from an option dict, seeded by ``reset_parameters``: a finite
    SR of the right size whose loss sends a gradient to every parameter."""
    net = build_network(net_opt)
    net.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.rand(2, 3, 6, 5, generator=torch.Generator().manual_seed(1))
    sr = net(x)
    assert tuple(sr.shape) == (2, 3, 24, 20) and torch.isfinite(sr).all()
    sr.square().mean().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in net.parameters())
