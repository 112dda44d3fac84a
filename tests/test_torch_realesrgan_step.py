"""The port's RealESRGAN-SSL train step against ssl_tpu's device-mode step
(``degradation_device: true``), from identical weights and GT + kernel
batches, with the JAX step's draws replayed from its ``state.rng``
(``tests/torch_realesrgan_cases.py``) and handed to ``train_step``.

Tiny widths (as tests/test_realesrgan_pipeline.py:128-170): RRDBNet nf 8 /
nb 1 / gc 4, UNetDiscriminatorSN nf 4, VGG19 at the shipped five layers,
SSL search 9 / window 5 (sigma 0.1, as tests/test_torch_train_step.py: at
0.004 the SSL loss's exponentials turn a one-level LQ tie into a 1e-4 loss
difference), GT 32, batch 2, 3 size buckets, ``queue_size`` 4: steps 1-2
fill the pool and step 3 draws from it.  The helpers and the other recipes'
test (tests/test_torch_realesrgan_recipes.py) share
tests/torch_realesrgan_cases.py.

Tolerances: losses rtol 1e-4 (float32 sums in another order; the LQ may
differ by one uint8 level at a rounding tie, tests/test_torch_degrade.py);
G, EMA and D parameters atol 2e-5 = lr / 5 (tests/test_torch_train_step.py
says why), plus 2.2 lr for each step at which the element's gradient was
below 1e-5 of the net's largest, where its sign is rounding noise and
Adam's early steps move it by about lr either way (the rule of
tests/torch_diffusion_train_cases.py::check_weights); at most 0.5% of a
net's elements may use that allowance (measured: 9 of G's and 4 of D's);
the spectral norms' u and sigma rtol 1e-5 with an atol of 1e-6, plus, where
the conv's weight differs by dW, 2 |dW|_F / sigma for u and 2 |dW|_F for
sigma (one power-iteration step moves u by about |dW| / sigma and sigma by
|dW|; measured 7.5e-6 on a u of D.conv3 after an allowed weight element);
the pool: GT and masks exactly, gt_usm atol 4e-6 (``usm_sharp``'s), LQ at
most one level on at most 2% of its values.  That share is the composite's
0.1% (tests/test_torch_degrade.py) widened for this size: a JPEG
coefficient within rounding of a half-integer in the jitted JAX step (the
same chain of JAX ops run eagerly rounds as the port does) moves its whole
8x8 block by a fraction of a level, which flips the values of the block that
lie near a rounding boundary; on an 8^2 LQ one such block is a sixteenth of
the image (measured: 6 of 384 values at step 1, one block)."""

import numpy as np
import pytest
import torch

from ssl_tpu_torch.models import build_model
from torch_realesrgan_cases import (B, G_OPT, GT, LOSSES, QSIZE, check_nets, check_pool,
                                    grad_watch, kernel_batch, nchw, pair, step, train_opt)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread (the suite runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_realesrgan_ssl_three_steps_match_jax_through_the_pool():
    jmodel, jstate, tmodel, tstate = pair(train_opt())
    noisy = grad_watch(tstate)
    fed = []
    for i in range(3):
        fed.append(kernel_batch(B, GT, i)["gt"])
        jstate, jlogs, tstate, tlogs = step(jmodel, jstate, tmodel, tstate, i)
        assert int(jstate.step) == tstate.step == i + 1
        for k in LOSSES:
            assert np.isfinite(tlogs[k]), k
            np.testing.assert_allclose(tlogs[k], float(jlogs[k]), rtol=1e-4, err_msg=f"{i} {k}")
        check_nets(jstate, tstate, noisy)
        check_pool(jstate, tstate)
    assert tstate.extra["queue_ptr"] == QSIZE
    # the full branch swapped pairs: the pool is no longer the first two batches in order
    first_two = nchw(np.concatenate(fed[:2])).numpy()
    assert not np.array_equal(tstate.extra["queue_gt"].numpy(), first_two)
    assert tlogs["l_selfsim"] > 0 and tlogs["l_percep"] > 0


def test_host_degradation_raises_and_inference_builds():
    """Host mode (``degradation_device: false``, or absent as in the JAX
    package's default) builds a host degrader and no device generators;
    tests/test_torch_realesr_degradation.py holds it against ssl_tpu."""
    opt = train_opt(degradation_device=False)
    opt["train"].pop("perceptual_opt")
    for o in (opt, {k: v for k, v in opt.items() if k != "degradation_device"}):
        model = build_model(o, device="cpu")
        assert model.degrades_on_host and model.degrader.scale == 4
        assert model.degrader.pool.queue_size == QSIZE
        assert model.init_state().extra is None
    test_opt = {"model_type": "RealESRGANSSLModel", "scale": 4, "is_train": False,
                "network_g": dict(G_OPT), "path": {}}
    state = build_model(test_opt, device="cpu").init_state()
    assert state.extra is None and state.opt_g is None


def test_pool_needs_a_batch_that_divides_it():
    from ssl_tpu_torch.models.realesrganssl_model import queue_shuffle
    batch = {"lq": torch.zeros(3, 3, 2, 2), "gt": torch.zeros(3, 3, 8, 8)}
    with pytest.raises(ValueError, match="divisible"):
        queue_shuffle({}, batch, 4, None)
