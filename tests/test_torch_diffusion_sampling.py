"""The port's samplers and serving chain against ssl_tpu's (fp32, CPU).

The JAX samplers draw their start latent and noise from ``jax.random``
inside; the test draws the same numbers (the samplers' own key splits) and
hands them to the port's samplers as ``x_init`` and ``noises``.  Configs and
seeded non-zero weights: tests/torch_diffusion_cases.py.  Tolerances: rtol
1e-4 with an atol of 1e-5 of the reference's largest value, as for one model
call (tests/test_torch_diffusion.py): three steps of these samplers are
contractions of the latent, so the per-call rounding does not grow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.diffusion import sampler as jsampler
from ssl_tpu.diffusion.ddpm_ssl import DiffusionSSLConfig as JCfg
from ssl_tpu.diffusion.ddpm_ssl import StableSRSSL as JModel
from ssl_tpu.diffusion.unet import EncoderUNetModelWT as JEnc
from ssl_tpu.diffusion.unet import UNetModelDualcondV2 as JUNet
from ssl_tpu.diffusion.vae import AutoencoderKL as JVAE
from ssl_tpu_torch.diffusion import sampler
from ssl_tpu_torch.diffusion.ddpm_ssl import DiffusionSSLConfig, StableSRSSL
from ssl_tpu_torch.diffusion.test_cli import load_jax_params
from ssl_tpu_torch.diffusion.unet import EncoderUNetModelWT, UNetModelDualcondV2
from ssl_tpu_torch.diffusion.vae import AutoencoderKL
from ssl_tpu_torch.utils.weight_port import params_from_jax
from torch_diffusion_cases import CFG, STRUCT, UNET, VAE, close, nchw, seeded_params

STEPS = 3


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, its VAE params, port model, port state, inputs)."""
    jm = JModel(JCfg(**CFG), unet=JUNet(**UNET), structcond=JEnc(**STRUCT), vae=JVAE(**VAE))
    rng = np.random.RandomState(0)
    lq = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    z = rng.randn(1, 16, 16, 4).astype(np.float32)
    t = np.asarray([5], np.int32)
    sp = seeded_params(jm.structcond, z, t, seed=11)
    feats = jm.structcond.apply({"params": sp}, z, t)
    null = (0.5 * rng.randn(CFG["context_len"], CFG["context_dim"])).astype(np.float32)
    params = {"structcond": sp, "null_context": null,
              "unet": seeded_params(jm.unet, z, t, null[None], feats, seed=12)}
    vp = seeded_params(jm.vae, lq, seed=13)

    tm = StableSRSSL(DiffusionSSLConfig(**CFG), unet=UNetModelDualcondV2(**UNET),
                     structcond=EncoderUNetModelWT(**STRUCT), vae=AutoencoderKL(**VAE))
    state = tm.init_state(seed=0, device="cpu")
    load_jax_params(state, params)
    state.frozen["vae"].load_state_dict(params_from_jax("AutoencoderKL", vp))
    return jm, params, vp, tm, state, {"lq": lq, "z_lq": z, "ctx": null[None]}


def jax_sampler(jm, params, fn, **kw):
    """A jitted JAX sampler over (rng, context, z_lq) with the model's weights."""
    def run(rng, ctx, z_lq):
        apply = lambda x, t, c, zl: jm.apply_model(params, x, t, c, zl)  # noqa: E731
        return fn(apply, jm.sched, z_lq.shape, rng, ctx, z_lq, steps=STEPS, **kw)
    return jax.jit(run)


def port_apply(tm, state):
    return lambda x, t, c, zl: tm.apply_model(tm.infer_params(state), x, t, c, zl)


def start_latent(key, shape):
    """The samplers' own first draw: ``rng, r0 = split(rng); normal(r0)``."""
    return jax.random.normal(jax.random.split(key)[1], shape)


@pytest.mark.parametrize("name", ["ddim", "plms"])
def test_deterministic_samplers_match_jax(pair, name):
    jm, params, _, tm, state, x = pair
    key = jax.random.PRNGKey(3)
    j_fn, t_fn = {"ddim": (jsampler.ddim_sample, sampler.ddim_sample),
                  "plms": (jsampler.plms_sample, sampler.plms_sample)}[name]
    ref = jax_sampler(jm, params, j_fn)(key, x["ctx"], x["z_lq"])
    x_init = nchw(start_latent(key, x["z_lq"].shape))
    got = t_fn(port_apply(tm, state), tm.sched, x_init.shape, None, torch.from_numpy(x["ctx"]),
               nchw(x["z_lq"]), steps=STEPS, x_init=x_init)
    assert float(jnp.abs(ref).std()) > 1e-2
    close(got.numpy().transpose(0, 2, 3, 1), ref)


def test_spaced_ddpm_matches_jax_with_its_noise(pair):
    jm, params, _, tm, state, x = pair
    key = jax.random.PRNGKey(4)
    ref = jax_sampler(jm, params, jsampler.spaced_ddpm_sample)(key, x["ctx"], x["z_lq"])
    shape = x["z_lq"].shape
    rng, r0 = jax.random.split(key)
    noises = []
    for _ in range(STEPS):
        rng, rn = jax.random.split(rng)
        noises.append(nchw(jax.random.normal(rn, shape)))
    got = sampler.spaced_ddpm_sample(port_apply(tm, state), tm.sched, (1, 4, 16, 16), None,
                                     torch.from_numpy(x["ctx"]), nchw(x["z_lq"]), steps=STEPS,
                                     x_init=nchw(jax.random.normal(r0, shape)), noises=noises)
    close(got.numpy().transpose(0, 2, 3, 1), ref)


def test_serving_chain_matches_jax(pair):
    """encode -> 3 DDIM steps -> decode, as the CLI runs it, flash switch on."""
    jm, params, vp, tm, state, x = pair
    _, r_enc, r_samp = jax.random.split(jax.random.PRNGKey(42), 3)
    lq = jnp.asarray(x["lq"])
    z_lq = jm.encode(vp, lq, r_enc)
    ctx = jnp.broadcast_to(params["null_context"], (1,) + params["null_context"].shape)
    z = jax_sampler(jm, params, jsampler.ddim_sample)(r_samp, ctx, z_lq)
    img = jm.decode(vp, z)

    vae, p = state.frozen["vae"], tm.infer_params(state)
    with torch.no_grad():
        mean, _ = vae.encode(nchw(lq))
        noise = nchw(jax.random.normal(r_enc, (1,) + tuple(mean.shape[2:]) + (mean.shape[1],)))
        got_lq = tm.encode(vae, nchw(lq), noise=noise)
        x_init = nchw(start_latent(r_samp, z_lq.shape))
        got_z = sampler.ddim_sample(port_apply(tm, state), tm.sched, x_init.shape, None,
                                    p["null_context"][None], got_lq, steps=STEPS, x_init=x_init)
        got_img = tm.decode(vae, got_z)
    for got, ref in ((got_lq, z_lq), (got_z, z), (got_img, img)):
        close(got.numpy().transpose(0, 2, 3, 1), ref)


def test_tiled_sample_blends_like_jax():
    """The serial canvas with an identity-like sample_fn: same tiles, same
    Gaussian weights, same blend."""
    z = np.random.RandomState(8).randn(1, 20, 24, 4).astype(np.float32)
    ref = jsampler.tiled_sample(lambda t: t * 2.0 + 1.0, jnp.asarray(z), tile=8, overlap=2)
    got = sampler.tiled_sample(lambda t: t * 2.0 + 1.0, nchw(z), tile=8, overlap=2)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    # one rank: data_parallel takes the serial path
    assert torch.equal(sampler.tiled_sample(lambda t: t * 2.0 + 1.0, nchw(z), tile=8, overlap=2,
                                            data_parallel=True), got)


def test_generator_draws_are_reproducible(pair):
    """With no x_init or noises, the draws come from the torch.Generator:
    the same seed gives the same sample."""
    _, _, _, tm, state, x = pair
    z_lq = nchw(x["z_lq"])
    runs = [sampler.spaced_ddpm_sample(port_apply(tm, state), tm.sched, z_lq.shape,
                                       torch.Generator().manual_seed(s), torch.from_numpy(x["ctx"]),
                                       z_lq, steps=2) for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
