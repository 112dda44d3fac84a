"""A JAX StableSR-SSL train state and the port's, built from the same seeded
non-zero weights (tests/torch_diffusion_cases.py), and the JAX step's own
draws, for the train-step parity tests.

The JAX state is assembled directly (``DiffusionTrainState`` with
``tx.init``) instead of through ``init_state``, whose jitted inits take
longer than the step: AdamW's and MultiSteps' initial state does not depend
on the weights' values.  SSL runs at search 9, window 5, sigma 0.1 on the
32^2 images of these configs (the shipped 25 / 9 / 0.004 is held in
tests/test_torch_ssg.py and on the card)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ssl_tpu.diffusion.ddpm_ssl import DiffusionSSLConfig as JCfg
from ssl_tpu.diffusion.ddpm_ssl import DiffusionTrainState
from ssl_tpu.diffusion.ddpm_ssl import StableSRSSL as JModel
from ssl_tpu.diffusion.unet import EncoderUNetModelWT as JEnc
from ssl_tpu.diffusion.unet import UNetModelDualcondV2 as JUNet
from ssl_tpu.diffusion.vae import AutoencoderKL as JVAE
from ssl_tpu.losses.ssl_loss import SSLSetting as JSSLSetting
from ssl_tpu.ops.ssg import SSGConfig as JSSGConfig
from ssl_tpu_torch.diffusion.ddpm_ssl import DiffusionSSLConfig, StableSRSSL, trainable
from ssl_tpu_torch.diffusion.test_cli import load_jax_params
from ssl_tpu_torch.diffusion.unet import EncoderUNetModelWT, UNetModelDualcondV2
from ssl_tpu_torch.diffusion.vae import AutoencoderKL
from ssl_tpu_torch.losses.ssl_loss import SSLSetting
from ssl_tpu_torch.ops.ssg import SSGConfig
from ssl_tpu_torch.utils.weight_port import params_from_jax
from torch_diffusion_cases import CFG, STRUCT, UNET, VAE, nchw, seeded_params

SSG = dict(search=9, window=5, sigma=0.1)
# a zoo strategy's options at these sizes (tiles of 16, search 7, window 3)
ZOO_OPTS = (("kernel_size", 7), ("kernel_size_center", 3), ("scaling_factor", 1.0),
            ("simself_dh", 16), ("simself_dw", 16), ("softmax_sr", True))
B, SIZE, LATENT = 2, 32, 16
LR = 5e-5                # StableSRSSL's default, as in the JAX package
GRAD_FLOOR = 1e-5        # of the largest gradient: below it a gradient is rounding noise
NOISE_SHARE = 0.05       # at most this share of the elements may sit below the floor


def check_logs(tlogs, jlogs):
    """The same log keys, each value within rtol 1e-4."""
    assert sorted(tlogs) == sorted(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]), rtol=1e-4, err_msg=k)


def check_weights(got: dict, ref: dict, grads: dict, scale: float = 1.0):
    """|got - ref| <= scale * lr / 5 where the gradient (``grads``, what
    AdamW applied) is resolved, and <= scale * 2.2 lr where it is below
    GRAD_FLOOR of the largest one, for at most NOISE_SHARE of the elements
    (tests/test_torch_diffusion_train.py says why)."""
    top = max(float(g.abs().max()) for g in grads.values())
    noisy = total = 0
    for name, r in ref.items():
        floor = grads[name].abs() < GRAD_FLOOR * top
        atol = scale * (LR / 5 + 2 * LR * floor.to(r.dtype))
        diff = (got[name] - r).abs()
        bad = diff > atol
        assert not bool(bad.any()), (name, float(diff.max()), float(grads[name][bad].abs().max()))
        noisy += int(floor.sum())
        total += r.numel()
    assert noisy <= NOISE_SHARE * total, (noisy, total)


def batch(seed=0):
    """Smooth GT in [0, 1], a noisy LQ of it (already at the GT size) and a
    mask of density 0.3, NHWC numpy."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE] / SIZE
    base = np.stack([np.sin(6 * yy) + np.cos(5 * xx), yy * xx, np.cos(8 * (yy + xx))], -1)
    gt = np.stack([base * 0.3 + 0.5, base * 0.25 + 0.45]).astype(np.float32)
    lq = np.clip(gt + rng.randn(*gt.shape) * 0.05, 0, 1).astype(np.float32)
    mask = (rng.rand(B, SIZE, SIZE, 1) < 0.3).astype(np.float32)
    return {"gt": gt, "lq": lq, "gt_mask": mask}


def torch_batch(b: dict) -> dict:
    return {k: nchw(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def weights(seed=0):
    """Seeded non-zero params {'unet', 'structcond', 'null_context'} and VAE
    params (numpy trees) at the tiny configs' shapes."""
    j_struct, j_unet, j_vae = JEnc(**STRUCT), JUNet(**UNET), JVAE(**VAE)
    rng = np.random.RandomState(seed)
    z = rng.randn(B, LATENT, LATENT, 4).astype(np.float32)
    t = np.asarray([3, 17], np.int32)
    sp = seeded_params(j_struct, z, t, seed=seed + 21)
    feats = j_struct.apply({"params": sp}, z, t)
    null = (0.5 * rng.randn(CFG["context_len"], CFG["context_dim"])).astype(np.float32)
    ctx = np.broadcast_to(null, (B,) + null.shape)
    params = {"structcond": sp, "null_context": null,
              "unet": seeded_params(j_unet, z, t, ctx, feats, seed=seed + 22)}
    return params, seeded_params(j_vae, np.zeros((B, SIZE, SIZE, 3), np.float32), seed=seed + 23)


def pair(parameterization="eps", accumulate=1, pixel_weight=0.1, seed=0, strategy=""):
    """(JAX model, JAX state, port model, port state) from one set of weights;
    ``strategy`` a key of the strategy zoo (ZOO_OPTS), '' the fused loss."""
    cfg = dict(CFG, parameterization=parameterization, pixel_weight=pixel_weight)
    ssl = dict(mask_stride=3, l1_weight=0.5, kl_weight=0.5, strategy=strategy,
               strategy_opts=ZOO_OPTS if strategy else (), capacity=64)
    jm = JModel(JCfg(**cfg), unet=JUNet(**UNET), structcond=JEnc(**STRUCT), vae=JVAE(**VAE),
                ssl_setting=JSSLSetting(ssg=JSSGConfig(**SSG), **ssl),
                accumulate=accumulate)
    params, vp = weights(seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = DiffusionTrainState(step=jnp.asarray(0, jnp.int32), rng=jax.random.PRNGKey(seed),
                                 params=jparams,
                                 frozen={"vae": jax.tree_util.tree_map(jnp.asarray, vp)},
                                 opt_state=jm.tx.init(jparams),
                                 ema_params=jax.tree_util.tree_map(jnp.copy, jparams))

    tm = StableSRSSL(DiffusionSSLConfig(**cfg), unet=UNetModelDualcondV2(**UNET),
                     structcond=EncoderUNetModelWT(**STRUCT), vae=AutoencoderKL(**VAE),
                     ssl_setting=SSLSetting(ssg=SSGConfig(**SSG), **ssl),
                     accumulate=accumulate)
    state = tm.init_state(seed=0, device="cpu")
    load_jax_params(state, params)
    state.frozen["vae"].load_state_dict(params_from_jax("AutoencoderKL", vp))
    return jm, jstate, tm, state


def param_names(params: dict) -> list[str]:
    """Names of ``trainable(params)``, in its order."""
    return ([f"unet.{n}" for n, _ in params["unet"].named_parameters()]
            + [f"structcond.{n}" for n, _ in params["structcond"].named_parameters()]
            + ["null_context"])


def capture_grads(state) -> dict:
    """The gradients AdamW applies, by parameter name, filled in when the
    optimizer steps."""
    grads = {}
    names = param_names(state.params)

    def hook(opt, args, kwargs):
        grads.update((n, p.grad.clone()) for n, p in zip(names, trainable(state.params)))
    state.opt.register_step_pre_hook(hook)
    return grads


def flat(params) -> dict:
    """Port params, or a JAX params tree, as {name: tensor}."""
    if isinstance(params["unet"], torch.nn.Module):
        return dict(zip(param_names(params), (t.detach() for t in trainable(params))))
    sd = params_from_jax("StableSRSSL", jax.tree_util.tree_map(np.asarray, params))
    out = {f"{net}.{k}": v for net in ("unet", "structcond") for k, v in sd[net].items()}
    out["null_context"] = sd["null_context"]
    return out


def jax_draws(jm, jstate) -> dict:
    """The draws of the JAX step from ``state.rng``, split as step_fn splits
    it (ssl_tpu/diffusion/ddpm_ssl.py:260), in the port's layout."""
    _, r_t, r_noise, r_enc = jax.random.split(jstate.rng, 4)
    shape = (B, LATENT, LATENT, 4)
    return {"t": torch.from_numpy(np.array(
                jax.random.randint(r_t, (B,), 0, jm.sched.num_timesteps), np.int64)),
            "noise": nchw(jax.random.normal(r_noise, shape)),
            "enc_noise": nchw(jax.random.normal(r_enc, (2 * B,) + shape[1:]))}


def jax_preview_draws() -> dict:
    """The JAX preview's fixed draws (ssl_tpu/diffusion/ddpm_ssl.py:354)."""
    r_noise, r_enc = jax.random.split(jax.random.PRNGKey(0))
    shape = (B, LATENT, LATENT, 4)
    return {"noise": nchw(jax.random.normal(r_noise, shape)),
            "enc_noise": nchw(jax.random.normal(r_enc, shape))}
