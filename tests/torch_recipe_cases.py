"""Shared pieces of the six bicubic GAN-SSL recipes' parity tests
(LDL, BebyGAN, SPSR, RankSRGAN-PI, SwinIR-GAN, ELAN-GAN): tiny option
dicts, a seeded paired batch, the JAX model and state with the port's
carried from them (G, EMA, D, SPSR's gradient D, RankSRGAN's Ranker), one
step of each, and the checks.

Sizes: GT 32, LQ 8, batch 2; UNetDiscriminatorSN nf 4 (the shipped D of five
recipes), SSL search 9 / window 5 at sigma 0.1 (tests/torch_realesrgan_cases.py
says why not 0.004); no perceptual term (its parity is held in
tests/test_torch_losses.py, and VGG19 would cost the time budget).

Tolerances (tests/test_torch_train_step.py's and, for the spectral norms and
the gradient elements near zero, tests/test_torch_realesrgan_step.py's):
losses rtol 1e-4; parameters atol 2e-5 = lr / 5, plus 2.2 lr for each step
at which an element's gradient was below 1e-5 of its net's largest (its sign
is rounding noise there and Adam's first steps move it by about lr either
way), on at most 0.5% of a net's elements; batch-norm statistics rtol 1e-4,
atol 1e-5; a spectral norm's u and sigma rtol 1e-5, atol 1e-6 plus what the
conv's weight difference dW moves them by (2 |dW|_F / sigma, 2 |dW|_F)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ssl_tpu.models import build_model as jax_build_model
from ssl_tpu_torch.models import build_model
from ssl_tpu_torch.utils.weight_port import params_from_jax

B, GT, SCALE = 2, 32, 4
LR = 1e-4
PARAM_ATOL = LR / 5
GRAD_FLOOR, NOISY_SHARE = 1e-5, 0.005
D_OPT = {"type": "UNetDiscriminatorSN", "num_in_ch": 3, "num_feat": 4, "skip_connection": True}
G_OPTS = {
    "RRDBNet": {"type": "RRDBNet", "num_in_ch": 3, "num_out_ch": 3, "num_feat": 8,
                "num_block": 1, "num_grow_ch": 4},
    "RRDBBebyGANNet": {"type": "RRDBBebyGANNet", "nf": 8, "nb": 1, "gc": 4},
    "SPSRNet": {"type": "SPSRNet", "nf": 4, "nb": 20, "gc": 32, "upscale": 4},
    "RankSRGANSRResNet": {"type": "RankSRGANSRResNet", "nf": 8, "nb": 2, "upscale": 4},
    "SwinIR": {"type": "SwinIR", "upscale": 4, "window_size": 4, "depths": [2],
               "embed_dim": 12, "num_heads": [2], "upsampler": "pixelshuffle", "num_feat": 8},
    "ELAN": {"type": "ELAN", "scale": 4, "m_elan": 2, "c_elan": 30, "window_sizes": [2, 4, 8]},
}
# recipe: (model_type, generator, its losses beside the ESRGAN-SSL ones)
RECIPES = {
    "LDLSSL": ("LDLSSLModel", "RRDBNet", ("l_g_artifacts",)),
    "BebyGANSSL": ("BebyGANSSLModel", "RRDBBebyGANNet", ("l_g_bbl", "l_g_bp")),
    "BebyGAN": ("BebyGANModel", "RRDBBebyGANNet", ("l_g_bbl", "l_g_bp")),
    "SwinIRGANSSL": ("SwinIRGANSSLModel", "SwinIR", ()),
    "ELANGANSSL": ("ELANGANSSLModel", "ELAN", ()),
    "RankSRGANPISSL": ("RankSRGANSSLModel", "RankSRGANSRResNet", ("l_g_rank",)),
    "SPSRSSL": ("SPSRSSLModel", "SPSRNet", ("l_g_grad_pix", "l_g_grad_branch", "l_g_gan_grad",
                                            "l_d_real_grad", "l_d_fake_grad")),
}
BASE_LOSSES = ("l_pix", "l_g_gan", "l_d_real", "l_d_fake", "l_g_total")
SSL_LOSSES = ("l_selfsim", "l_selfsim_kl")


def train_opt(recipe: str, **train_extra) -> dict:
    """A tiny option dict of ``recipe`` with the shipped recipe's own keys."""
    model_type, g, _ = RECIPES[recipe]
    adam = {"type": "Adam", "lr": LR, "weight_decay": 0, "betas": [0.9, 0.99]}
    opt = {
        "name": f"{recipe}_parity", "model_type": model_type, "scale": SCALE, "num_devices": 1,
        "manual_seed": 0, "datasets": {"train": {"gt_size": GT}},
        "network_g": dict(G_OPTS[g]), "network_d": dict(D_OPT), "path": {},
        "ssl_setting": {"mask_stride": 3, "impl": "dense", "kernel_size_search": 9,
                        "sigma": 0.1, "kernel_size_window": 5, "generalization": True},
        "train": {
            "ema_decay": 0.999, "optim_g": dict(adam), "optim_d": dict(adam),
            "scheduler": {"type": "MultiStepLR", "milestones": [400000], "gamma": 0.5},
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1e-2, "reduction": "mean"},
            "selfsim_opt": {"type": "L1Loss", "loss_weight": 1e3, "reduction": "mean"},
            "selfsim1_opt": {"type": "KLDistanceLoss", "loss_weight": 1e3, "reduction": "mean",
                             "softmax": False},
            "gan_opt": {"type": "GANLoss", "gan_type": "vanilla", "real_label_val": 1.0,
                        "fake_label_val": 0.0, "loss_weight": 5e-3},
            "net_d_iters": 1, "net_d_init_iters": 0}}
    if recipe == "BebyGAN":
        del opt["ssl_setting"], opt["train"]["selfsim_opt"], opt["train"]["selfsim1_opt"]
    if recipe == "LDLSSL":
        opt["train"]["artifacts_opt"] = {"type": "L1Loss", "loss_weight": 1.0}
    if recipe.startswith("BebyGAN"):
        opt["train"]["bbl_opt"] = {"loss_weight": 1.0, "alpha": 1.0, "beta": 1.0, "ksize": 3,
                                   "stride": 3}
        opt["train"]["back_projection_opt"] = {"loss_weight": 1.0}
    if recipe == "RankSRGANPISSL":
        opt["network_d"] = {"type": "Discriminator_VGG_296", "nf": 4}
        opt["network_r"] = {"type": "Ranker_VGG12_296", "nf": 4}
        opt["train"]["rank_opt"] = {"loss_weight": 0.03, "R_bias": 0.0}
    if recipe == "SPSRSSL":
        opt["network_d_grad"] = dict(D_OPT)
        opt["train"]["gradient_pixel_opt"] = {"loss_weight": 1.0}
        opt["train"]["gradient_branch_opt"] = {"loss_weight": 0.5}
    opt["train"].update(train_extra)
    return opt


def losses(recipe: str) -> tuple:
    return BASE_LOSSES + (() if recipe == "BebyGAN" else SSL_LOSSES) + RECIPES[recipe][2]


def batch(seed: int) -> dict:
    """GT: smooth fields (continuous values, so no best-buddy distances tie);
    LQ: its 4x4 means plus noise; an edge mask of density 0.3.  NHWC numpy."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:GT, 0:GT] / GT
    gt = np.stack([np.stack([np.sin(f[0] * yy + f[1]) + np.cos(f[2] * xx), yy * xx + f[3],
                             np.cos(f[4] * (yy + xx))], -1) * 0.3 + 0.5
                   for f in rng.rand(B, 5) * 6]).astype(np.float32)
    lq = gt.reshape(B, GT // SCALE, SCALE, GT // SCALE, SCALE, 3).mean(axis=(2, 4))
    lq = lq + rng.randn(*lq.shape) * 0.02
    mask = (rng.rand(B, GT, GT, 1) < 0.3).astype(np.float32)
    return {"lq": lq.astype(np.float32), "gt": gt, "gt_mask": mask}


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nets(jstate, tstate):
    """(name, port module, JAX params, JAX stats, family) of every trained net."""
    d_params, d_stats = jstate.params_d, jstate.stats_d
    out = [("G", tstate.net_g, jstate.params_g, None),
           ("EMA", tstate.net_g_ema, jstate.ema_params_g, None)]
    if "net_d_grad" in tstate.nets:
        out += [("D", tstate.net_d, d_params["img"], d_stats["img"]),
                ("D_grad", tstate.nets["net_d_grad"], d_params["grad"], d_stats["grad"])]
    else:
        out.append(("D", tstate.net_d, d_params, d_stats))
    return [(n, net, to_np(p), None if s is None else to_np(s), type(net).__name__)
            for n, net, p, s in out]


def pair(opt):
    """The JAX model and state and the port's, with every net carried across."""
    jmodel = jax_build_model(copy.deepcopy(opt))
    jstate = jmodel.init_state(lq_shape=(B, GT // SCALE, GT // SCALE, 3))
    tmodel = build_model(copy.deepcopy(opt), device="cpu")
    tstate = tmodel.init_state(seed=0)
    for _, net, params, stats, family in nets(jstate, tstate):
        missing, unexpected = net.load_state_dict(params_from_jax(family, params, stats),
                                                  strict=False)
        assert not unexpected and all("num_batches_tracked" in k for k in missing), missing
    if tstate.extra and "net_r" in tstate.extra:
        extra = to_np(jstate.extra)
        tstate.extra["net_r"].load_state_dict(params_from_jax(
            "Ranker_VGG12_296", extra["params_r"], extra["stats_r"]), strict=False)
    return jmodel, jstate, tmodel, tstate


def step(jmodel, jstate, tmodel, tstate, seed):
    data = batch(seed)
    jstate, jlogs = jmodel.train_step(jstate, {k: jnp.asarray(v) for k, v in data.items()})
    tstate, tlogs = tmodel.train_step(tstate, {k: nchw(v) for k, v in data.items()})
    return jstate, to_np(jlogs), tstate, {k: float(v) for k, v in tlogs.items()}


def grad_watch(tstate) -> dict:
    """{net name: {param: steps so far with a gradient below the floor}},
    counted as each optimizer steps."""
    noisy = {}
    groups = [("opt_g", [("G", tstate.net_g)]),
              ("opt_d", [("D", tstate.net_d)] + [("D_grad", n) for n in tstate.nets.values()])]
    for opt_name, members in groups:
        for name, net in members:
            noisy[name] = {n: torch.zeros_like(p) for n, p in net.named_parameters()}

        def hook(o, args, kwargs, members=members):
            for name, net in members:
                grads = {n: p.grad for n, p in net.named_parameters() if p.grad is not None}
                top = max(float(g.abs().max()) for g in grads.values())
                for n, g in grads.items():
                    noisy[name][n] += (g.abs() < GRAD_FLOOR * top).float()
        getattr(tstate, opt_name).register_step_pre_hook(hook)
    return noisy


def check_logs(jlogs, tlogs, keys):
    for k in keys:
        np.testing.assert_allclose(tlogs[k], float(jlogs[k]), rtol=1e-4, err_msg=k)


def check_nets(jstate, tstate, noisy):
    off = {}
    for name, net, params, stats, family in nets(jstate, tstate):
        got = net.state_dict()
        ref = params_from_jax(family, params, stats)
        for k, v in ref.items():
            if k.endswith((".u", ".sigma")):
                conv = k.rsplit(".", 1)[0]
                dw = float((got[f"{conv}.weight"] - ref[f"{conv}.weight"]).norm())
                extra = 2 * dw / (float(ref[f"{conv}.sigma"]) if k.endswith(".u") else 1.0)
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                           atol=1e-6 + extra, err_msg=f"{name} {k}")
            elif "running" in k:
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                           err_msg=f"{name} {k}")
            else:
                steps = noisy["G" if name == "EMA" else name][k].numpy()
                atol = PARAM_ATOL + 2.2 * LR * (steps if name != "EMA" else 0.0)
                diff = np.abs(got[k].detach().numpy() - v.numpy())
                assert (diff <= atol).all(), (name, k, float(diff.max()))
                n, total = off.get(name, (0, 0))
                off[name] = (n + int((diff > PARAM_ATOL).sum()), total + diff.size)
    for name, (n, total) in off.items():
        assert n <= NOISY_SHARE * total, (name, n, total)
