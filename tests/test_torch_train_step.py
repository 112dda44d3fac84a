"""The port's ESRGAN-SSL train step against ssl_tpu's, from identical weights
and batch (fp32, CPU): losses, G / D parameters, D batch-norm stats and the
EMA after 1 and after 3 steps, and the ``net_d_init_iters`` gate.

Tiny nets (RRDBNet nf 8 / nb 1 / gc 4, VGGStyleDiscriminator nf 4 at 128^2),
batch 2, SSL at search 9 / window 5; the perceptual loss is left out here
(its parity is pinned in test_torch_losses.py and VGG19 at 128^2 would cost
the time budget).

Tolerances: losses rtol 1e-4 (float32 sums in different orders); BN stats
rtol 1e-4, atol 1e-5; parameters atol 2e-5 = lr / 5.  Adam's first steps
move each parameter by about lr * sign(g), so a gradient component near zero
whose sign differed between the frameworks would show as an lr-sized
difference; on these inputs none does (largest difference measured 2.4e-6,
in D), so the tolerance sits well below lr and a wrong update cannot hide
in it."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.models import build_model as jax_build_model
from ssl_tpu_torch.models import build_model
from ssl_tpu_torch.utils.weight_port import params_from_jax

LOSSES = ("l_pix", "l_selfsim", "l_selfsim_kl", "l_g_gan", "l_d_real", "l_d_fake")
PARAM_ATOL = 2e-5


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the suite runs several test processes on the
    machine's cores, and torch's thread pools contending for them slow this
    file's CPU steps by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt(init_iters=0, ssl=True, gan=True):
    opt = {
        "name": "parity", "model_type": "ESRGANSSLModel", "scale": 4, "num_devices": 1,
        "manual_seed": 0, "datasets": {"train": {"gt_size": 128}},
        "network_g": {"type": "RRDBNet", "num_in_ch": 3, "num_out_ch": 3, "num_feat": 8,
                      "num_block": 1, "num_grow_ch": 4},
        "network_d": {"type": "VGGStyleDiscriminator", "num_in_ch": 3, "num_feat": 4,
                      "input_size": 128},
        "path": {},
        "ssl_setting": {"mask_stride": 3, "impl": "dense", "kernel_size_search": 9,
                        "sigma": 0.1, "kernel_size_window": 5, "generalization": True},
        "train": {
            "ema_decay": 0.999,
            "optim_g": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "optim_d": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [2], "gamma": 0.5},
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1e-2, "reduction": "mean"},
            "selfsim_opt": {"type": "L1Loss", "loss_weight": 1e3, "reduction": "mean"},
            "selfsim1_opt": {"type": "KLDistanceLoss", "loss_weight": 1e3, "reduction": "mean",
                             "softmax": False},
            "gan_opt": {"type": "GANLoss", "gan_type": "vanilla", "real_label_val": 1.0,
                        "fake_label_val": 0.0, "loss_weight": 5e-3},
            "net_d_iters": 1, "net_d_init_iters": init_iters,
        },
    }
    if not ssl:
        opt["model_type"] = "ESRGANModel"
        del opt["ssl_setting"], opt["train"]["selfsim_opt"], opt["train"]["selfsim1_opt"]
    if not gan:
        opt["model_type"] = "SRModel"
        del opt["network_d"], opt["train"]["gan_opt"], opt["train"]["optim_d"]
    return opt


def _batch():
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:128, 0:128] / 128
    base = np.stack([np.sin(6 * yy) + np.cos(5 * xx), yy * xx, np.cos(8 * (yy + xx))], -1)
    gt = np.stack([base * 0.3 + 0.5, base * 0.25 + 0.45]).astype(np.float32)
    lq = gt.reshape(2, 32, 4, 32, 4, 3).mean(axis=(2, 4)) + rng.randn(2, 32, 32, 3) * 0.02
    mask = (rng.rand(2, 128, 128, 1) < 0.3).astype(np.float32)
    return {"lq": lq.astype(np.float32), "gt": gt, "gt_mask": mask}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run_pair(opt, n_steps):
    """Run both step functions from the JAX init; returns, after each step,
    (jax logs, jax state, torch logs, torch state dicts of g / g_ema / d)."""
    batch = _batch()
    jmodel = jax_build_model(copy.deepcopy(opt))
    jstate = jmodel.init_state(lq_shape=(2, 32, 32, 3))
    tmodel = build_model(copy.deepcopy(opt), device="cpu")
    tstate = tmodel.init_state(seed=0)
    g_sd = params_from_jax("RRDBNet", _np(jstate.params_g))
    tstate.net_g.load_state_dict(g_sd)
    tstate.net_g_ema.load_state_dict(g_sd)
    if tstate.net_d is not None:
        tstate.net_d.load_state_dict(params_from_jax(
            "VGGStyleDiscriminator", _np(jstate.params_d), _np(jstate.stats_d)), strict=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy()) for k, v in batch.items()}
    out = []
    for _ in range(n_steps):
        jstate, jlogs = jmodel.train_step(jstate, jbatch)
        tstate, tlogs = tmodel.train_step(tstate, tbatch)
        snap = {name: copy.deepcopy(getattr(tstate, f"net_{name}").state_dict())
                for name in ("g", "g_ema", "d") if getattr(tstate, f"net_{name}") is not None}
        out.append((_np(jlogs), _np(jstate), {k: float(v) for k, v in tlogs.items()}, snap))
    return out


def _compare(jlogs, jstate, tlogs, tsnap, losses):
    for k in losses:
        np.testing.assert_allclose(tlogs[k], float(jlogs[k]), rtol=1e-4, err_msg=k)
    nets = [("G", tsnap["g"], jstate.params_g, None),
            ("EMA", tsnap["g_ema"], jstate.ema_params_g, None)]
    if "d" in tsnap:
        nets.append(("D", tsnap["d"], jstate.params_d, jstate.stats_d))
    for name, got, tree, stats in nets:
        family = "VGGStyleDiscriminator" if name == "D" else "RRDBNet"
        ref = params_from_jax(family, tree, stats)
        for k, v in ref.items():
            if "running" in k:
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                           err_msg=f"{name} {k}")
            else:
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL,
                                           err_msg=f"{name} {k}")


def test_esrgan_ssl_step_matches_jax_after_1_and_3_steps():
    runs = _run_pair(_opt(), 3)
    for step in (0, 2):
        jlogs, jstate, tlogs, tsnap = runs[step]
        assert int(jstate.step) == step + 1
        _compare(jlogs, jstate, tlogs, tsnap, LOSSES)
    # the MultiStepLR milestone at 2 halves lr for the third update
    assert [r[2]["lr"] for r in runs] == pytest.approx([float(r[0]["lr"]) for r in runs])
    assert runs[2][2]["lr"] == pytest.approx(0.5e-4)
    # three steps moved G by more than the parameter tolerance
    first, last = runs[0][3]["g"], runs[2][3]["g"]
    assert max(float((first[k] - last[k]).abs().max()) for k in first) > PARAM_ATOL


def test_net_d_init_iters_gate_matches_jax():
    """net_d_init_iters 2: G (and so the EMA's target) stays put for two
    steps while D and Adam's G moments advance, then moves at step 3."""
    runs = _run_pair(_opt(init_iters=2, ssl=False), 3)
    g0 = params_from_jax("RRDBNet", runs[0][1].params_g)
    for step in range(3):
        jlogs, jstate, tlogs, tsnap = runs[step]
        _compare(jlogs, jstate, tlogs, tsnap, ("l_pix", "l_g_gan", "l_d_real", "l_d_fake"))
        moved = any(not torch.equal(v, tsnap["g"][k]) for k, v in g0.items())
        assert moved == (step == 2)


def test_sr_model_step_matches_jax():
    """The plain SRModel recipe (pixel loss, Adam, EMA; no D) after 2 steps."""
    runs = _run_pair(_opt(gan=False), 2)
    for jlogs, jstate, tlogs, tsnap in runs:
        _compare(jlogs, jstate, tlogs, tsnap, ("l_pix", "l_total"))
