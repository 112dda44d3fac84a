"""The port's BSRGANSSLModel train step against ssl_tpu's, from identical
weights and batches (fp32, CPU): the losses, G, its EMA, the U-Net D and its
spectral norms after each of two steps.

The option dict is the KAIR adapter's output for a tiny KAIR file
(``tests/torch_kair_cases.py``: BSRGANRRDBNet nf 8 / nb 1 / gc 4,
UNetDiscriminatorSN nf 4, lsgan through the relativistic ESRGAN terms,
E_decay 0.999, the stride-3 mask lattice, SSL search 9 / window 5 at sigma
0.1, and the shipped five-layer perceptual loss with VGG19's weights carried
across).  The batch, tolerances and checks are the six recipes' (GT 32, LQ
8, batch 2; tests/torch_recipe_cases.py)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.models import build_model as jax_build_model
from ssl_tpu_torch.models import build_model
from ssl_tpu_torch.utils.kair_options import kair_to_opt
from ssl_tpu_torch.utils.weight_port import params_from_jax
from torch_kair_cases import tiny_kair
from torch_recipe_cases import (B, GT, SCALE, batch, check_logs, check_nets, grad_watch, nchw,
                                nets, to_np)

LOSSES = ("l_pix", "l_percep", "l_g_gan", "l_selfsim", "l_selfsim_kl", "l_d_real", "l_d_fake",
          "l_g_total")


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread (the suite runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt():
    opt = kair_to_opt(tiny_kair({k: "/unused" for k in ("gt", "mask", "vgt", "vlq")}, "step"))
    opt["train"]["scheduler"]["milestones"] = [400000]
    return dict(opt, is_train=True, num_devices=1)


def test_bsrgan_ssl_two_steps_match_jax():
    opt = _opt()
    assert opt["model_type"] == "BSRGANSSLModel" and opt["train"]["mask_stride"] == 3
    assert opt["train"]["gan_opt"]["gan_type"] == "lsgan"
    jmodel = jax_build_model(copy.deepcopy(opt))
    jstate = jmodel.init_state(lq_shape=(B, GT // SCALE, GT // SCALE, 3))
    tmodel = build_model(copy.deepcopy(opt), device="cpu")
    tstate = tmodel.init_state(seed=0)
    assert tmodel.ssl_setting.mask_stride == 3 and tmodel.ema_decay == 0.999
    for _, net, params, stats, family in nets(jstate, tstate):
        missing, unexpected = net.load_state_dict(params_from_jax(family, params, stats),
                                                  strict=False)
        assert not unexpected and not missing, (family, missing, unexpected)
    tmodel.cri_perceptual.vgg.load_state_dict(params_from_jax(
        "VGGFeatureExtractor", to_np(jmodel.cri_perceptual.variables["params"])))
    noisy = grad_watch(tstate)
    for seed in range(2):
        data = batch(seed)
        jstate, jlogs = jmodel.train_step(jstate, {k: jnp.asarray(v) for k, v in data.items()})
        tstate, tlogs = tmodel.train_step(tstate, {k: nchw(v) for k, v in data.items()})
        tlogs = {k: float(v) for k, v in tlogs.items()}
        assert set(LOSSES) <= set(tlogs) and all(np.isfinite(tlogs[k]) for k in LOSSES)
        assert tlogs["l_selfsim"] > 0 and tlogs["l_percep"] > 0
        check_logs(to_np(jlogs), tlogs, LOSSES)
        check_nets(jstate, tstate, noisy)


def test_mask_stride_3_is_applied():
    """The same step with ``train.mask_stride`` 3 and 0: the SSL terms
    differ (the lattice keeps a third of a third of the mask's pixels)."""
    logs = {}
    for stride in (3, 0):
        opt = _opt()
        opt["train"]["mask_stride"] = stride
        opt["train"].pop("perceptual_opt")
        model = build_model(opt, device="cpu")
        state = model.init_state(seed=0)
        _, out = model.train_step(state, {k: nchw(v) for k, v in batch(0).items()})
        logs[stride] = float(out["l_selfsim"])
    assert logs[3] > 0 and logs[0] > 0 and logs[3] != logs[0]
