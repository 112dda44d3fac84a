"""Shared pieces of the RealESRGAN-SSL parity tests: the JAX step's draws
replayed into the port's ``DegradeDraws``, tiny option dicts, GT + kernel
batches, and the train-step pair with its checks (the tolerances are
tests/test_torch_realesrgan_step.py's docstring's).

The JAX package draws its degradation from ``jax.random`` keys folded off
``state.rng`` (``0x5351`` for the degradation, ``0x51`` for the pool's
permutation: ssl_tpu/models/realesrganssl_model.py:166,176).  ``jax_draws``
makes the same ``split`` / ``fold_in`` / ``choice`` / ``randint`` /
``uniform`` / ``normal`` calls on the same keys as
``ssl_tpu/ops/degrade_jax.py::degrade_two_stage_jax`` and returns what they
chose; its Poisson function draws ``jax.random.poisson`` on the key the JAX
step would use, at the rate the port hands it."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ssl_tpu.models import build_model as jax_build_model
from ssl_tpu.ops.degrade_jax import DegradeJaxConfig
from ssl_tpu_torch.models import build_model
from ssl_tpu_torch.ops.degrade import DegradeDraws, StageDraws, bucket_index, bucket_table
from ssl_tpu_torch.utils.weight_port import params_from_jax

G_OPT = {"type": "RRDBNet", "num_in_ch": 3, "num_out_ch": 3, "num_feat": 8, "num_block": 1,
         "num_grow_ch": 4}
D_OPT = {"type": "UNetDiscriminatorSN", "num_in_ch": 3, "num_feat": 4, "skip_connection": True}
SSL_OPT = {"mask_stride": 3, "impl": "dense", "kernel_size_search": 9, "sigma": 0.1,
           "kernel_size_window": 5, "generalization": True}
PERCEPTUAL = {"type": "PerceptualLoss",
              "layer_weights": {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1, "conv4_4": 1,
                                "conv5_4": 1},
              "vgg_type": "vgg19", "use_input_norm": True, "perceptual_weight": 1.0,
              "style_weight": 0, "range_norm": False, "criterion": "l1"}
# the shipped option file's degradation values (train_RealESRGANSSL_x4.yml)
DEGRADE = {"degradation_order": "two", "degradation_device": True,
           "resize_prob": [0.2, 0.7, 0.1], "resize_range": [0.15, 1.5],
           "gaussian_noise_prob": 0.5, "noise_range": [1, 30], "poisson_scale_range": [0.05, 3],
           "gray_noise_prob": 0.4, "jpeg_range": [30, 95], "second_blur_prob": 0.8,
           "resize_prob2": [0.3, 0.4, 0.3], "resize_range2": [0.3, 1.2],
           "gaussian_noise_prob2": 0.5, "noise_range2": [1, 25],
           "poisson_scale_range2": [0.05, 2.5], "gray_noise_prob2": 0.4,
           "jpeg_range2": [30, 95],
           # 3 size buckets instead of 7: both packages read n_buckets, and the
           # JAX step compiles one branch per bucket and mode; the 7-bucket
           # table is held in tests/test_torch_degrade.py
           "n_buckets": 3}


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2), order="C"))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().numpy().transpose(0, 2, 3, 1))


def _stage(key, ikey, cfg, stage2, b, base, n, noise: dict) -> StageDraws:
    """One ``_rand_resize_switch`` + ``_add_noise`` of degrade_jax.py."""
    probs = cfg.resize_prob2 if stage2 else cfg.resize_prob
    rrange = cfg.resize_range2 if stage2 else cfg.resize_range
    sizes, one_idx = bucket_table(rrange, base, n)
    k1, k2, k3 = jax.random.split(key, 3)
    updown = int(jax.random.choice(k1, 3, p=jnp.asarray(probs)))
    up_idx = int(jax.random.randint(k2, (), one_idx, n))
    down_idx = int(jax.random.randint(k3, (), 0, one_idx + 1))
    mode = int(jax.random.choice(jax.random.fold_in(key, 7), 3))
    bucket = bucket_index(updown, up_idx, down_idx, one_idx)
    s = sizes[bucket]
    gp = cfg.gaussian_noise_prob2 if stage2 else cfg.gaussian_noise_prob
    nr = cfg.noise_range2 if stage2 else cfg.noise_range
    pr = cfg.poisson_scale_range2 if stage2 else cfg.poisson_scale_range
    grayp = cfg.gray_noise_prob2 if stage2 else cfg.gray_noise_prob
    kf, ks, kg, kn, kp = jax.random.split(ikey, 5)
    use_gauss = bool(jax.random.uniform(kf) < gp)
    sigma = jax.random.uniform(ks, (b, 1, 1, 1), minval=nr[0], maxval=nr[1])
    gray = (jax.random.uniform(kg, (b, 1, 1, 1)) < grayp).astype(jnp.float32)
    normals = jax.random.normal(kn, (b, s, s, 3))
    normals_gray = jax.random.normal(jax.random.fold_in(kn, 1), (1, s, s, 1))
    pscale = jax.random.uniform(kp, (b, 1, 1, 1), minval=pr[0], maxval=pr[1])
    noise[2 if stage2 else 1] = jax.random.split(jax.random.fold_in(kn, 2))

    def flat(a):
        return torch.from_numpy(np.asarray(a).reshape(b).copy())
    return StageDraws(updown, bucket, mode, use_gauss, flat(gray), sigma=flat(sigma),
                      normals=nchw(normals), normals_gray=nchw(normals_gray),
                      pscale=flat(pscale))


def jax_draws(key, cfg: DegradeJaxConfig, b: int, gt_size: int) -> DegradeDraws:
    """What ``degrade_two_stage_jax(key, gt (b, gt_size, gt_size, 3), ...)``
    draws, as the port's ``DegradeDraws``."""
    keys = jax.random.split(key, 12)
    noise = {}
    stage1 = _stage(keys[0], keys[1], cfg, False, b, gt_size, cfg.n_buckets, noise)
    jpeg1 = jax.random.uniform(keys[2], (b,), minval=cfg.jpeg_range[0], maxval=cfg.jpeg_range[1])
    do_blur2 = bool(jax.random.uniform(keys[3]) < cfg.second_blur_prob)
    stage2 = _stage(keys[4], keys[5], cfg, True, b, gt_size // cfg.scale, cfg.n_buckets, noise)
    first_sinc = bool(jax.random.uniform(keys[6]) < 0.5)
    jpeg2 = jax.random.uniform(keys[7] if first_sinc else keys[8], (b,),
                               minval=cfg.jpeg_range2[0], maxval=cfg.jpeg_range2[1])

    def poisson(rate, stage, which):
        k = noise[stage][0 if which == "gray" else 1]
        draw = jax.random.poisson(k, jnp.asarray(nhwc(rate))).astype(jnp.float32)
        return nchw(draw)
    return DegradeDraws(stage1, torch.from_numpy(np.asarray(jpeg1).copy()), do_blur2, stage2,
                        first_sinc, torch.from_numpy(np.asarray(jpeg2).copy()), poisson)


def jax_step_draws(rng, cfg: DegradeJaxConfig, b: int, gt_size: int, qsize: int,
                   pool_full: bool) -> dict:
    """The draws of one JAX train step from its incoming ``state.rng``, in the
    layout of the port's ``_DegradationMixin.draws``."""
    perm = None
    if pool_full:
        perm = torch.from_numpy(np.asarray(jax.random.permutation(
            jax.random.fold_in(rng, 0x51), qsize)).astype(np.int64))
    return {"degrade": jax_draws(jax.random.fold_in(rng, 0x5351), cfg, b, gt_size),
            "perm": perm}


def kernel_batch(b: int, gt_size: int, seed: int, mask: bool = True) -> dict:
    """Smooth GT with sharp blocks, a mask of density 0.25 and kernels from
    the JAX package's synthesis (NHWC numpy)."""
    import random
    from ssl_tpu.data.realesrgan_dataset import _KernelSynth
    rng = np.random.RandomState(seed)
    random.seed(seed)
    np.random.seed(seed)
    yy, xx = np.mgrid[0:gt_size, 0:gt_size] / gt_size
    gts = []
    for i in range(b):
        f = rng.rand(3, 3) * 6 + 1
        img = np.stack([0.5 + 0.3 * np.sin(f[c, 0] * yy + f[c, 1] * xx + f[c, 2])
                        for c in range(3)], -1)
        y0, x0 = rng.randint(0, gt_size // 2, 2)
        img[y0:y0 + gt_size // 3, x0:x0 + gt_size // 3] = rng.rand(3)
        gts.append(np.clip(img + rng.randn(*img.shape) * 0.02, 0, 1))
    synth = _KernelSynth({})
    ks = [synth.sample() for _ in range(b)]
    out = {"gt": np.stack(gts).astype(np.float32),
           "kernel1": np.stack([k[0] for k in ks]), "kernel2": np.stack([k[1] for k in ks]),
           "sinc_kernel": np.stack([k[2] for k in ks])}
    if mask:
        out["gt_mask"] = (rng.rand(b, gt_size, gt_size, 1) < 0.25).astype(np.float32)
    return out


def torch_batch(batch: dict) -> dict:
    return {k: nchw(v) if v.ndim == 4 else torch.from_numpy(v) for k, v in batch.items()}


# The train-step pair of tests/test_torch_realesrgan_{step,recipes}.py: batch,
# GT size, pool slots and learning rate, and the holds that docstring states.
B, GT, QSIZE, LR = 2, 32, 4, 1e-4
PARAM_ATOL = LR / 5
GRAD_FLOOR, NOISY_SHARE = 1e-5, 0.005
LOSSES = ("l_pix", "l_percep", "l_selfsim", "l_selfsim_kl", "l_g_gan", "l_d_real", "l_d_fake")


def train_opt(model_type="RealESRGANSSLModel", **extra):
    """A tiny option dict of the recipe, the shipped degradation values."""
    opt = {
        "name": "realesrgan_parity", "model_type": model_type, "scale": 4, "num_devices": 1,
        "manual_seed": 0, "queue_size": QSIZE, **DEGRADE,
        "datasets": {"train": {"gt_size": GT}},
        "network_g": dict(G_OPT), "network_d": dict(D_OPT), "path": {},
        "ssl_setting": dict(SSL_OPT),
        "train": {
            "ema_decay": 0.999,
            "optim_g": {"type": "Adam", "lr": LR, "weight_decay": 0, "betas": [0.9, 0.99]},
            "optim_d": {"type": "Adam", "lr": LR, "weight_decay": 0, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [400000], "gamma": 0.5},
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0, "reduction": "mean"},
            "selfsim_opt": {"type": "L1Loss", "loss_weight": 1e3, "reduction": "mean"},
            "selfsim1_opt": {"type": "KLDistanceLoss", "loss_weight": 1e3, "reduction": "mean",
                             "softmax": False},
            "perceptual_opt": dict(PERCEPTUAL),
            "gan_opt": {"type": "GANLoss", "gan_type": "vanilla", "real_label_val": 1.0,
                        "fake_label_val": 0.0, "loss_weight": 1e-1},
            "net_d_iters": 1, "net_d_init_iters": 0}}
    opt.update(extra)
    return opt


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair(opt):
    """The JAX model and state and the port's, carrying G, its EMA, D (with
    its spectral norms' u and sigma) and the VGG19 weights across."""
    jmodel = jax_build_model(copy.deepcopy(opt))
    jstate = jmodel.init_state(lq_shape=(B, GT // 4, GT // 4, 3))
    tmodel = build_model(copy.deepcopy(opt), device="cpu")
    tstate = tmodel.init_state(seed=0)
    g_sd = params_from_jax("RRDBNet", to_np(jstate.params_g))
    tstate.net_g.load_state_dict(g_sd)
    if tstate.net_g_ema is not None:
        tstate.net_g_ema.load_state_dict(g_sd)
    if tstate.net_d is not None:
        tstate.net_d.load_state_dict(params_from_jax(
            "UNetDiscriminatorSN", to_np(jstate.params_d), to_np(jstate.stats_d)))
    if tmodel.cri_perceptual is not None:
        tmodel.cri_perceptual.vgg.load_state_dict(params_from_jax(
            "VGGFeatureExtractor", to_np(jmodel.cri_perceptual.variables["params"])))
    return jmodel, jstate, tmodel, tstate


def step(jmodel, jstate, tmodel, tstate, seed):
    """One step of each on the same batch, the port on the JAX step's draws."""
    batch = kernel_batch(B, GT, seed)
    qsize = int(jmodel.opt.get("queue_size", 0) or 0)
    full = qsize > 0 and tstate.extra.get("queue_ptr", 0) >= qsize
    draws = jax_step_draws(jnp.asarray(np.asarray(jstate.rng)), jmodel.degrade_cfg, B, GT,
                           qsize, full)
    jstate, jlogs = jmodel.train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tlogs = tmodel.train_step(tstate, torch_batch(batch), draws)
    return jstate, to_np(jlogs), tstate, {k: float(v) for k, v in tlogs.items()}


def grad_watch(tstate) -> dict:
    """{net: {param: steps so far with a gradient below the floor}}, counted
    as each optimizer steps."""
    noisy = {}
    for name, net, opt in (("G", tstate.net_g, tstate.opt_g), ("D", tstate.net_d, tstate.opt_d)):
        if net is None:
            continue
        counts = noisy[name] = {n: torch.zeros_like(p) for n, p in net.named_parameters()}

        def hook(o, args, kwargs, net=net, counts=counts):
            grads = dict(net.named_parameters())
            top = max(float(p.grad.abs().max()) for p in grads.values())
            for n, p in grads.items():
                counts[n] += (p.grad.abs() < GRAD_FLOOR * top).float()
        opt.register_step_pre_hook(hook)
    return noisy


def check_nets(jstate, tstate, noisy):
    off = {}
    for name, net, tree, stats, family in (
            ("G", tstate.net_g, jstate.params_g, None, "RRDBNet"),
            ("EMA", tstate.net_g_ema, jstate.ema_params_g, None, "RRDBNet"),
            ("D", tstate.net_d, jstate.params_d, jstate.stats_d, "UNetDiscriminatorSN")):
        if net is None:
            continue
        got = net.state_dict()
        ref = params_from_jax(family, to_np(tree), None if stats is None else to_np(stats))
        for k, v in ref.items():
            if k.endswith((".u", ".sigma")):
                conv = k.rsplit(".", 1)[0]
                dw = float((got[f"{conv}.weight"] - ref[f"{conv}.weight"]).norm())
                extra = 2 * dw / (float(ref[f"{conv}.sigma"]) if k.endswith(".u") else 1.0)
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                           atol=1e-6 + extra, err_msg=f"{name} {k}")
            else:
                steps = noisy["D" if name == "D" else "G"][k].numpy()
                atol = PARAM_ATOL + 2.2 * LR * (steps if name != "EMA" else 0.0)
                diff = np.abs(got[k].detach().numpy() - v.numpy())
                assert (diff <= atol).all(), (name, k, float(diff.max()))
                n, total = off.get(name, (0, 0))
                off[name] = (n + int((diff > PARAM_ATOL).sum()), total + diff.size)
    for name, (n, total) in off.items():
        assert n <= NOISY_SHARE * total, (name, n, total)


def check_pool(jstate, tstate):
    extra = to_np(jstate.extra)
    assert tstate.extra["queue_ptr"] == int(extra["queue_ptr"])
    for k in ("gt", "gt_mask"):
        np.testing.assert_array_equal(tstate.extra[f"queue_{k}"].numpy(),
                                      nchw(extra[f"queue_{k}"]).numpy(), err_msg=k)
    np.testing.assert_allclose(tstate.extra["queue_gt_usm"].numpy(),
                               nchw(extra["queue_gt_usm"]).numpy(), rtol=0, atol=4e-6)
    levels = np.abs(np.round(tstate.extra["queue_lq"].numpy() * 255)
                    - np.round(nchw(extra["queue_lq"]).numpy() * 255))
    assert levels.max() <= 1 and (levels > 0).mean() <= 0.02, (levels > 0).mean()
