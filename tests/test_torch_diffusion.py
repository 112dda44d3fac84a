"""The port's diffusion modules against ssl_tpu's (fp32, CPU): schedules,
struct-cond encoder, dual-cond UNet, VAE, color fixes and the weight carry.

Configs and seeded non-zero weights: tests/torch_diffusion_cases.py.
Tolerances: rtol 1e-4 with an atol of 1e-5 of the reference's largest value
(the two frameworks sum convolutions and norms in other orders); the
schedule arrays are equal (both come from the same float64 numpy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.diffusion import color_fix as jcolor
from ssl_tpu.diffusion import schedules as jsched
from ssl_tpu.diffusion.unet import EncoderUNetModelWT as JEnc
from ssl_tpu.diffusion.unet import UNetModelDualcondV2 as JUNet
from ssl_tpu.diffusion.vae import AutoencoderKL as JVAE
from ssl_tpu.utils import weight_port as jport
from ssl_tpu_torch.diffusion import color_fix, schedules
from ssl_tpu_torch.diffusion.unet import EncoderUNetModelWT, UNetModelDualcondV2
from ssl_tpu_torch.diffusion.vae import AutoencoderKL
from ssl_tpu_torch.utils.weight_port import params_from_jax
from torch_diffusion_cases import STRUCT, UNET, VAE, close, nchw, seeded_params


def carry(net, family, params):
    net.load_state_dict(params_from_jax(family, params))   # strict: every name must match
    return net.eval()


@pytest.fixture(scope="module")
def nets():
    rng = np.random.RandomState(0)
    z = rng.randn(2, 16, 16, 4).astype(np.float32)
    t = np.asarray([3, 17], np.int32)
    ctx = rng.randn(2, 4, 32).astype(np.float32)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    j_struct, j_unet, j_vae = JEnc(**STRUCT), JUNet(**UNET), JVAE(**VAE)
    sp = seeded_params(j_struct, z, t, seed=1)
    feats = j_struct.apply({"params": sp}, z, t)
    up = seeded_params(j_unet, z, t, ctx, feats, seed=2)
    vp = seeded_params(j_vae, img, seed=3)
    return {"z": z, "t": t, "ctx": ctx, "img": img, "feats": feats,
            "j": (j_struct, j_unet, j_vae), "params": (sp, up, vp),
            "port": (carry(EncoderUNetModelWT(**STRUCT), "EncoderUNetModelWT", sp),
                     carry(UNetModelDualcondV2(**UNET), "UNetModelDualcondV2", up),
                     carry(AutoencoderKL(**VAE), "AutoencoderKL", vp))}


@pytest.mark.parametrize("kind", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_schedule_arrays_match_jax(kind):
    betas = jsched.make_beta_schedule(kind, 50, 0.00085, 0.012)
    np.testing.assert_array_equal(schedules.make_beta_schedule(kind, 50, 0.00085, 0.012), betas)
    ref, got = jsched.build_schedule_arrays(betas), schedules.build_schedule_arrays(betas)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert got.num_timesteps == ref.num_timesteps == 50
    for counts in (7, 50, [3, 5]):
        assert schedules.space_timesteps(50, counts) == jsched.space_timesteps(50, counts)


def test_forward_process_matches_jax():
    sched_j = jsched.build_schedule_arrays(jsched.make_beta_schedule("linear", 50))
    sched_t = schedules.build_schedule_arrays(schedules.make_beta_schedule("linear", 50))
    rng = np.random.RandomState(4)
    x0, noise, xt = (rng.randn(2, 4, 8, 8).astype(np.float32) for _ in range(3))
    t = np.asarray([10, 40])
    tt = torch.from_numpy(t)
    a, b_, c = (torch.from_numpy(v) for v in (x0, noise, xt))
    pairs = [(schedules.q_sample(sched_t, a, tt, b_), jsched.q_sample(sched_j, x0, t, noise)),
             (schedules.predict_start_from_noise(sched_t, c, tt, b_),
              jsched.predict_start_from_noise(sched_j, xt, t, noise)),
             (schedules.get_v(sched_t, a, b_, tt), jsched.get_v(sched_j, x0, noise, t)),
             (schedules.predict_start_from_v(sched_t, c, tt, b_),
              jsched.predict_start_from_v(sched_j, xt, t, noise)),
             *zip(schedules.q_posterior(sched_t, a, c, tt), jsched.q_posterior(sched_j, x0, xt, t))]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_structcond_forward_matches_jax(nets):
    got = nets["port"][0](nchw(nets["z"]), torch.from_numpy(nets["t"]))
    assert sorted(got) == sorted(nets["feats"]) == ["16", "8"]
    for key, ref in nets["feats"].items():
        assert float(np.abs(np.asarray(ref)).max()) > 0
        close(got[key].detach().numpy().transpose(0, 2, 3, 1), ref)


def test_unet_forward_matches_jax(nets):
    """The struct features are the JAX encoder's, so this holds the UNet alone."""
    j_unet, up = nets["j"][1], nets["params"][1]
    ref = j_unet.apply({"params": up}, nets["z"], nets["t"], nets["ctx"], nets["feats"])
    feats = {k: nchw(v) for k, v in nets["feats"].items()}
    with torch.no_grad():
        got = nets["port"][1](nchw(nets["z"]), torch.from_numpy(nets["t"]),
                              torch.from_numpy(nets["ctx"]), feats).numpy()
    assert float(np.abs(np.asarray(ref)).std()) > 1e-2
    close(got.transpose(0, 2, 3, 1), ref)


def test_vae_encode_decode_match_jax(nets):
    j_vae, vp, vae = nets["j"][2], nets["params"][2], nets["port"][2]
    mean, logvar = j_vae.apply({"params": vp}, nets["img"], method=j_vae.encode)
    z = np.random.RandomState(5).randn(*np.shape(mean)).astype(np.float32)
    dec = j_vae.apply({"params": vp}, z, method=j_vae.decode)
    with torch.no_grad():
        got_mean, got_logvar = vae.encode(nchw(nets["img"]))
        got_dec = vae.decode(nchw(z))
    for got, ref in ((got_mean, mean), (got_logvar, logvar), (got_dec, dec)):
        close(got.numpy().transpose(0, 2, 3, 1), ref)


def test_vae_group_count_and_downsample_padding():
    """ch 16 is not a multiple of 32: gcd(16, 32) = 16 groups; the encoder's
    stride-2 conv pads one row and column after the image only."""
    vae = AutoencoderKL(**VAE)
    assert vae.encoder.down[0].block[0].norm1.num_groups == 16
    assert vae.encoder.down[1].block[0].norm2.num_groups == 32
    assert vae.encoder.down[0].downsample.conv.padding == (0, 0)
    assert not hasattr(vae.encoder.down[1], "downsample") and not hasattr(vae.decoder.up[0], "upsample")


def test_color_fixes_match_jax():
    rng = np.random.RandomState(6)
    target = rng.rand(2, 32, 32, 3).astype(np.float32)
    source = (rng.rand(2, 32, 32, 3) * 0.5 + 0.25).astype(np.float32)
    for fix_t, fix_j in ((color_fix.adain_color_fix, jcolor.adain_color_fix),
                         (color_fix.wavelet_color_fix, jcolor.wavelet_color_fix)):
        got = fix_t(nchw(target), nchw(source)).numpy().transpose(0, 2, 3, 1)
        for i in range(2):
            np.testing.assert_allclose(got[i], fix_j(target[i], source[i]), rtol=1e-6, atol=1e-6)


def test_weight_carry_round_trips_through_the_reference_converters(nets):
    """The port's state dicts, read as StableSR / ldm checkpoints by the JAX
    package's own converters, give back the flax trees they came from: the
    port's module names are StableSR's and ldm's."""
    for net, params, convert in zip(nets["port"], nets["params"],
                                    (jport.convert_sd_structcond, jport.convert_sd_unet,
                                     jport.convert_ldm_vae)):
        sd = {k: v.numpy() for k, v in net.state_dict().items()}
        back = convert(sd)
        flat_ref = jax.tree_util.tree_leaves_with_path(params)
        flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_back) == len(flat_ref)
        for path, leaf in flat_ref:
            np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf, err_msg=str(path))


def test_weight_carry_of_the_full_param_dict(nets):
    sp, up, _ = nets["params"]
    null = np.random.RandomState(7).randn(4, 32).astype(np.float32)
    out = params_from_jax("StableSRSSL", {"unet": up, "structcond": sp, "null_context": null})
    assert sorted(out) == ["null_context", "structcond", "unet"]
    assert torch.equal(out["null_context"], torch.from_numpy(null))
    assert sorted(out["unet"]) == sorted(nets["port"][1].state_dict())
    assert out["unet"]["input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight"].shape == (32, 32)
    assert out["structcond"]["middle_block.1.qkv.weight"].shape == (192, 64, 1)


def test_jax_flax_input_is_jnp_friendly(nets):
    """params_from_jax also takes jax arrays as leaves (np.asarray reads them)."""
    sd = params_from_jax("AutoencoderKL", jax.tree_util.tree_map(jnp.asarray, nets["params"][2]))
    assert sorted(sd) == sorted(nets["port"][2].state_dict())
