"""The port's RealESRGANModel and RealESRNetModel train steps against
ssl_tpu's device-mode steps, one step each, with the JAX step's draws
replayed (tests/torch_realesrgan_cases.py): RealESRGANModel has no SSL and,
as the JAX package builds it, a non-relativistic GAN against
UNetDiscriminatorSN; RealESRNetModel has the pixel loss against the
USM-sharpened GT and no D.  No pool, no perceptual loss.  Widths and
tolerances as tests/test_torch_realesrgan_step.py states them."""

import numpy as np
import pytest
import torch

from torch_realesrgan_cases import check_nets, grad_watch, pair, step, train_opt


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread (the suite runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("model_type", ["RealESRGANModel", "RealESRNetModel"])
def test_other_degradation_recipes_match_jax_for_one_step(model_type):
    """RealESRGANModel (no SSL, a non-relativistic GAN, as the JAX package
    builds it) and RealESRNetModel (pixel loss against the USM-sharpened GT,
    no D); no pool, no perceptual loss."""
    opt = train_opt(model_type, queue_size=0)
    del opt["ssl_setting"], opt["train"]["selfsim_opt"], opt["train"]["selfsim1_opt"]
    del opt["train"]["perceptual_opt"]
    if model_type == "RealESRNetModel":
        del opt["network_d"], opt["train"]["gan_opt"], opt["train"]["optim_d"]
    jmodel, jstate, tmodel, tstate = pair(opt)
    noisy = grad_watch(tstate)
    jstate, jlogs, tstate, tlogs = step(jmodel, jstate, tmodel, tstate, 5)
    keys = ("l_pix",) if model_type == "RealESRNetModel" else ("l_pix", "l_g_gan", "l_d_real",
                                                              "l_d_fake")
    for k in keys:
        np.testing.assert_allclose(tlogs[k], float(jlogs[k]), rtol=1e-4, err_msg=k)
    check_nets(jstate, tstate, noisy)
    assert "queue_ptr" not in tstate.extra
