"""The port's UNetDiscriminatorSN against the flax one, on the CPU.

nf 4 on 32^2, the flax init's params and spectral-norm state carried across
by ``params_from_jax``: three successive train-mode calls (the logits, and
each conv's u and sigma after each call, which flax's ``update_stats``
stores) and one eval-mode call, which runs a power-iteration step but
stores nothing.  rtol 1e-5, with an atol of 1e-5 of the largest value
(float32 convolutions summed in another order: without the skips the nine
spectrally normalized layers shrink the logits to ~1e-3 of their inputs'
scale, so a logit's rounding is that of the sums behind it; measured 4.6e-9
on logits up to 6.2e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.archs.discriminator_arch import UNetDiscriminatorSN as JaxUNetD
from ssl_tpu_torch.archs import UNetDiscriminatorSN
from ssl_tpu_torch.utils.weight_port import params_from_jax


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got: torch.Tensor, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=1e-5 * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("skip", [True, False])
def test_unet_discriminator_sn_matches_flax(skip):
    jnet = JaxUNetD(num_feat=4, skip_connection=skip)
    variables = jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))
    params, stats = variables["params"], variables["batch_stats"]
    net = UNetDiscriminatorSN(num_feat=4, skip_connection=skip)
    net.load_state_dict(params_from_jax("UNetDiscriminatorSN", _np(params), _np(stats)))
    rng = np.random.RandomState(skip)
    for _ in range(3):
        x = rng.rand(2, 32, 32, 3).astype(np.float32)
        want, new = jnet.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), True,
                               mutable=["batch_stats"])
        stats = new["batch_stats"]
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        assert tuple(got.shape) == (2, 1, 32, 32)
        _close(got.permute(0, 2, 3, 1), want)
        ref = params_from_jax("UNetDiscriminatorSN", _np(params), _np(stats))
        for k, v in net.state_dict().items():
            if k.endswith((".u", ".sigma")):
                _close(v, ref[k].numpy())
    before = {k: v.clone() for k, v in net.state_dict().items()}
    net.eval()
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    want = jnet.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), False)
    _close(net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).permute(0, 2, 3, 1), want)
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())


def test_spectral_norm_gradient_reaches_the_weight_through_sigma():
    """sigma = v W u^T carries W's gradient (flax stops only u and v): the
    gradient of a conv's output sum w.r.t. its raw weight equals autograd
    through W / sigma with u and v held fixed."""
    net = UNetDiscriminatorSN(num_feat=4)
    net.reset_parameters(torch.Generator().manual_seed(0))
    conv = net.conv1
    x = torch.rand(1, 4, 8, 8, generator=torch.Generator().manual_seed(1))
    u0 = conv.u.clone()
    conv(x).sum().backward()
    w = conv.weight.detach().clone().requires_grad_(True)
    mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
    v = u0 @ mat.detach().T
    v = v * torch.rsqrt((v * v).sum() + 1e-12)
    u = v @ mat.detach()
    u = u * torch.rsqrt((u * u).sum() + 1e-12)
    sigma = (v @ mat @ u.T)[0, 0]
    wbar = (mat / sigma).reshape(4, 4, 4, 8).permute(3, 2, 0, 1)
    torch.nn.functional.conv2d(x, wbar, None, 2, 1).sum().backward()
    torch.testing.assert_close(conv.weight.grad, w.grad, rtol=1e-5, atol=1e-7)
    assert torch.equal(conv.u, u.detach())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        UNetDiscriminatorSN(num_feat=4, compute_dtype="bfloat16")
