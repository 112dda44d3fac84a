"""The diffusion tree's ``compute_dtype: bfloat16`` in the port against
ssl_tpu's, on the CPU: the struct-cond encoder, the dual-cond UNet and the
VAE in bf16 against JAX's bf16 and against the port's own float32 (the JAX
contract of tests/test_diffusion.py:400-480), K2's plain bf16 contract, one
bf16 training mini-step and one bf16 denoising step against JAX's, the
config fan-out, and K2's bf16 launch geometry.

Widths are those of tests/test_diffusion.py:408-419 (model_channels 32,
channel_mult (1, 2), VAE ch 16) with attention at every level
(tests/torch_diffusion_cases.py); inputs come from numpy seeds and the
weights from JAX's seeded params, carried through ``utils/weight_port``.
flax and torch round bf16 at other points (bias adds, norm outputs, GELU,
XLA keeping values in float32 inside a fusion), so the two bf16 routes
differ by about as much as each differs from float32: the bounds are the
JAX contract's 3e-2 of the reference's largest value, with the values
measured on the CPU in the comments."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.diffusion import sampler as jsampler
from ssl_tpu.diffusion.ddpm_ssl import DiffusionSSLConfig as JCfg
from ssl_tpu.diffusion.ddpm_ssl import StableSRSSL as JModel
from ssl_tpu.diffusion.schedules import predict_start_from_noise, q_sample
from ssl_tpu.diffusion.unet import EncoderUNetModelWT as JEnc
from ssl_tpu.diffusion.unet import UNetModelDualcondV2 as JUNet
from ssl_tpu.diffusion.vae import AutoencoderKL as JVAE
from ssl_tpu.losses.ssl_loss import SSLSetting as JSSLSetting
from ssl_tpu.losses.ssl_loss import ssl_loss as jssl_loss
from ssl_tpu.ops import attention as jattn
from ssl_tpu.ops.ssg import SSGConfig as JSSGConfig
from ssl_tpu_torch.diffusion import sampler
from ssl_tpu_torch.diffusion.ddpm_ssl import DiffusionSSLConfig, StableSRSSL, trainable
from ssl_tpu_torch.diffusion.main import build_from_config
from ssl_tpu_torch.diffusion.test_cli import load_jax_params
from ssl_tpu_torch.diffusion.unet import (EncoderUNetModelWT, UNetModelDualcondV2,
                                          init_params)
from ssl_tpu_torch.diffusion.vae import AutoencoderKL
from ssl_tpu_torch.losses.ssl_loss import SSLSetting
from ssl_tpu_torch.ops import attention, attention_cuda
from ssl_tpu_torch.ops.ssg import SSGConfig
from ssl_tpu_torch.utils.weight_port import params_from_jax
from torch_attention_cases import CUDA_CASES, TRAIN_CASES, attention_inputs
from torch_diffusion_cases import CFG, STRUCT, UNET, VAE, nchw, seeded_params
from torch_diffusion_train_cases import SSG, batch, jax_draws, torch_batch, weights

BF16 = "bfloat16"
BOUND = 3e-2            # of the reference's largest value (the JAX contract's)


def scaled_err(got, ref) -> float:
    """max |got - ref| / max |ref|, got NCHW torch or NHWC numpy, ref NHWC."""
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
        if got.ndim == 4:
            got = got.transpose(0, 2, 3, 1)
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref.double()).norm() / ref.double().norm())


def carry(net, family, params):
    net.load_state_dict(params_from_jax(family, params))   # strict: every name must match
    return net.eval()


@pytest.fixture(scope="module")
def nets():
    """The seeds of tests/test_torch_diffusion.py's fixture; JAX's bf16
    outputs from one jitted function per network, the port's bf16 and
    float32 networks on the same carried weights."""
    rng = np.random.RandomState(0)
    z = rng.randn(2, 16, 16, 4).astype(np.float32)
    t = np.asarray([3, 17], np.int32)
    ctx = rng.randn(2, 4, 32).astype(np.float32)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    lat = rng.randn(2, 16, 16, 4).astype(np.float32)
    j_struct, j_unet, j_vae = JEnc(**STRUCT), JUNet(**UNET), JVAE(**VAE)
    j16 = (JEnc(**STRUCT, compute_dtype=BF16), JUNet(**UNET, compute_dtype=BF16),
           JVAE(**VAE, compute_dtype=BF16))
    sp = seeded_params(j_struct, z, t, seed=1)
    feats = j_struct.apply({"params": sp}, z, t)
    up = seeded_params(j_unet, z, t, ctx, feats, seed=2)
    vp = seeded_params(j_vae, img, seed=3)
    ref = {"feats": jax.jit(j16[0].apply)({"params": sp}, z, t),
           "eps": jax.jit(j16[1].apply)({"params": up}, z, t, ctx, feats),
           "moments": jax.jit(lambda p, x: j16[2].apply(p, x, method=j16[2].encode))(
               {"params": vp}, img),
           "decoded": jax.jit(lambda p, x: j16[2].apply(p, x, method=j16[2].decode))(
               {"params": vp}, lat)}

    def port(dtype):
        return (carry(EncoderUNetModelWT(**STRUCT, compute_dtype=dtype), "EncoderUNetModelWT", sp),
                carry(UNetModelDualcondV2(**UNET, compute_dtype=dtype), "UNetModelDualcondV2", up),
                carry(AutoencoderKL(**VAE, compute_dtype=dtype), "AutoencoderKL", vp))

    return {"z": z, "t": t, "ctx": ctx, "img": img, "lat": lat, "feats": feats, "ref": ref,
            "bf16": port(BF16), "f32": port(None)}


def port_outputs(nets, which):
    struct, unet, vae = nets[which]
    t = torch.from_numpy(nets["t"])
    with torch.no_grad():
        feats = struct(nchw(nets["z"]), t)
        eps = unet(nchw(nets["z"]), t, torch.from_numpy(nets["ctx"]),
                   {k: nchw(v) for k, v in nets["feats"].items()})
        mean, logvar = vae.encode(nchw(nets["img"]))
        decoded = vae.decode(nchw(nets["lat"]))
    return {"feats": feats, "eps": eps, "mean": mean, "logvar": logvar, "decoded": decoded}


def test_networks_bf16_match_jax_bf16(nets):
    """Each network's bf16 outputs against JAX's bf16 on the same weights:
    struct-cond features (measured 9.8e-3 at 16^2, 1.6e-2 at 8^2), UNet eps
    (2.5e-2), VAE moments' mean and logvar (1.3e-2, 1.2e-2) and decode of a
    latent (1.7e-2), each below 3e-2 of the reference's largest value; every
    output float32."""
    got, ref = port_outputs(nets, "bf16"), nets["ref"]
    jmean, jlogvar = ref["moments"]
    pairs = [(got["feats"][k], ref["feats"][k]) for k in ref["feats"]]
    pairs += [(got["eps"], ref["eps"]), (got["mean"], jmean), (got["logvar"], jlogvar),
              (got["decoded"], ref["decoded"])]
    for i, (g, r) in enumerate(pairs):
        assert g.dtype == torch.float32 and r.dtype == jnp.float32
        assert scaled_err(g, r) < BOUND, (i, scaled_err(g, r))


def test_bf16_deviates_from_float32_by_the_jax_contract(nets):
    """tests/test_diffusion.py:442-479 on the port: float32 parameters,
    float32 outputs within 3e-2 of the float32 route's scale (measured 7.7e-3
    and 1.1e-2 for the features, 2.0e-2 eps, 1.1e-2 / 8.6e-3 moments, 1.3e-2
    decode)."""
    for net in nets["bf16"]:
        assert all(p.dtype == torch.float32 for p in net.parameters())
    got, ref = port_outputs(nets, "bf16"), port_outputs(nets, "f32")
    for k in ("eps", "mean", "logvar", "decoded"):
        assert got[k].dtype == torch.float32
        assert float((got[k] - ref[k]).abs().max() / ref[k].abs().max()) < BOUND, k
    for k in ref["feats"]:
        assert float((got["feats"][k] - ref["feats"][k]).abs().max()
                     / ref["feats"][k].abs().max()) < BOUND, k


def test_unet_bf16_gradient_keeps_its_direction(nets):
    """The UNet's parameter gradient of mean((eps - 1)^2) in bf16 against
    float32, after JAX's perturbation off the zero-init manifold (flax-style
    init with the zero layers, plus 0.02 N(0, 1) on every parameter): float32
    gradients with cosine > 0.98 (measured 0.999994)."""
    net32 = init_params(UNetModelDualcondV2(**UNET), torch.Generator().manual_seed(4))
    rng = np.random.RandomState(6)
    with torch.no_grad():
        for p in net32.parameters():
            p.add_(torch.from_numpy(0.02 * rng.randn(*p.shape).astype(np.float32)))
    net16 = UNetModelDualcondV2(**UNET, compute_dtype=BF16)
    net16.load_state_dict(net32.state_dict())
    args = (nchw(nets["z"]), torch.from_numpy(nets["t"]), torch.from_numpy(nets["ctx"]),
            {k: nchw(v) for k, v in nets["feats"].items()})
    flat = []
    for net in (net32, net16):
        net.zero_grad()
        ((net(*args) - 1.0) ** 2).mean().backward()
        assert all(p.grad.dtype == torch.float32 for p in net.parameters())
        flat.append(torch.cat([p.grad.flatten() for p in net.parameters()]).double())
    cos = float(flat[0] @ flat[1] / (flat[0].norm() * flat[1].norm()))
    assert cos > 0.98, cos


@pytest.mark.parametrize("b,heads,n,m,d,layout", [
    (2, 4, 512, 512, 32, "proj"),       # UNet self-attention at an eligible length
    (2, 4, 256, 77, 32, "proj"),        # cross-attention over the text context
    (1, 2, 512, 512, 16, "qkv"),        # strided views of a packed qkv
])
def test_plain_attention_bf16_matches_jax(b, heads, n, m, d, layout):
    """The plain bf16 route (bf16 einsums, softmax in float32) against JAX's
    einsum path on the same bf16 inputs: within two bf16 roundings of the
    reference's largest value, 2·2^-7 of it (measured 1.1e-2, 9.1e-3 and
    2.9e-4: the logits agree, the float32 probabilities and the sums over
    the keys differ in their last bits, which moves an output by a bf16 ulp
    where it lies near a rounding boundary)."""
    scale = d ** -0.5
    q, k, v = attention_inputs(b, heads, n, m, d, scale, layout, 8.0, seed=n + m,
                               dtype=torch.bfloat16)
    got = attention.sdp_attention(q, k, v, scale, use_flash=True)
    assert got.dtype == torch.bfloat16
    ref = jattn.sdp_attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
                              scale, use_flash=True)
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(got.float().numpy() - ref).max() <= 2 * 2 ** -7 * np.abs(ref).max()


@pytest.mark.parametrize("d,layout,logits", [(64, "proj", 8.0), (64, "qkv", 8.0),
                                             (64, "proj", 50.0), (128, "qkv", 8.0)])
def test_backward_reference_bf16_stays_near_float32(d, layout, logits):
    """``flash_attn_bwd_reference`` on bf16 inputs (the kernels' rounding
    points) against the float32 formula on the same values upcast: dq, dk and
    dv in bf16 within 1e-2 relative L2 (measured 2.1e-3 to 5.5e-3, the
    largest at logits of 50)."""
    b, h, n, scale = 1, 2, 256, d ** -0.5
    q, k, v = attention_inputs(b, h, n, n, d, scale, layout, logits, seed=d,
                               dtype=torch.bfloat16)
    do = torch.from_numpy(np.random.RandomState(1).randn(b, n, h, d).astype(np.float32))
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do.bfloat16()))
    o = attention.sdp_attention_reference(q32, k32, v32, scale)
    lse = attention.attention_lse_reference(q, k, scale)
    assert lse.dtype == torch.float32
    torch.testing.assert_close(lse, attention.attention_lse_reference(q32, k32, scale))
    got = attention.flash_attn_bwd_reference(q, k, v, o.bfloat16(), lse, do32.bfloat16(), scale)
    ref = attention.flash_attn_bwd_reference(q32, k32, v32, o, lse, do32, scale)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16
        assert rel_l2(g.float(), r) <= 1e-2, name


@pytest.mark.parametrize("layout", ["proj", "qkv"])
def test_plain_bf16_gradient_matches_jax_grad(layout):
    """Autograd through the plain bf16 route against ``jax.grad`` of JAX's
    bf16 ``sdp_attention`` (the function both packages differentiate off the
    card): dq, dk and dv within 2e-2 relative L2 (measured 3.6e-3 to 5.2e-3;
    both round the logits, the probabilities and each product to bf16, at
    other points)."""
    b, h, n, d = 1, 2, 512, 32
    scale = d ** -0.5
    q, k, v = attention_inputs(b, h, n, n, d, scale, layout, 8.0, seed=3, dtype=torch.bfloat16)
    w = np.random.RandomState(2).randn(b, n, h, d).astype(np.float32)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    (attention.sdp_attention(*leaves, scale, use_flash=True).float()
     * torch.from_numpy(w)).sum().backward()

    def f(qj, kj, vj):
        return jnp.sum(jattn.sdp_attention(qj, kj, vj, scale, use_flash=True).astype(jnp.float32)
                       * w)
    refs = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                            for t in (q, k, v)))
    for name, leaf, r in zip(("dq", "dk", "dv"), leaves, refs):
        assert leaf.grad.dtype == torch.bfloat16
        ref = torch.from_numpy(np.array(r.astype(jnp.float32)))
        assert rel_l2(leaf.grad.float(), ref) <= 2e-2, name


def bf16_models():
    """(JAX model, port model and state) in bf16 on the train cases' weights."""
    cfg = dict(CFG, parameterization="eps", pixel_weight=0.1)
    setting = dict(mask_stride=3, l1_weight=0.5, kl_weight=0.5)
    jm = JModel(JCfg(**cfg), unet=JUNet(**UNET, compute_dtype=BF16),
                structcond=JEnc(**STRUCT, compute_dtype=BF16),
                vae=JVAE(**VAE, compute_dtype=BF16),
                ssl_setting=JSSLSetting(ssg=JSSGConfig(**SSG), **setting))
    tm = StableSRSSL(DiffusionSSLConfig(**cfg),
                     unet=UNetModelDualcondV2(**UNET, compute_dtype=BF16),
                     structcond=EncoderUNetModelWT(**STRUCT, compute_dtype=BF16),
                     vae=AutoencoderKL(**VAE, compute_dtype=BF16),
                     ssl_setting=SSLSetting(ssg=SSGConfig(**SSG), **setting))
    params, vp = weights(0)
    state = tm.init_state(seed=0, device="cpu")
    load_jax_params(state, params)
    state.frozen["vae"].load_state_dict(params_from_jax("AutoencoderKL", vp))
    return jm, tm, state, params, vp


@functools.lru_cache(maxsize=None)
def _bf16_models():
    return bf16_models()


def test_bf16_mini_step_matches_jax():
    """One training mini-step under compute_dtype bfloat16 with JAX's draws:
    the port's ``train_step`` logs against the JAX step's loss function (its
    ``loss_fn``, ssl_tpu/diffusion/ddpm_ssl.py:264-322, composed from the
    package's own encode, apply_model, decode and ssl_loss, forward only: the
    jitted gradient step takes minutes to compile on the CPU), each within
    3e-2 relative (measured at most 1.9e-3, l_selfsim_kl); the weights,
    their gradients, AdamW's moments and the EMA stay float32."""
    jm, tm, state, params, vp = _bf16_models()
    b = batch()
    draws = jax_draws(jm, types.SimpleNamespace(rng=jax.random.PRNGKey(0)))

    @jax.jit
    def jax_logs(params, vp, batch, t, noise, enc_noise):
        gt, lq = batch["gt"] * 2.0 - 1.0, batch["lq"] * 2.0 - 1.0
        mean, logvar = jm.vae.apply({"params": vp}, jnp.concatenate([gt, lq]),
                                    method=jm.vae.encode)
        z0, z_lq = jnp.split((mean + jnp.exp(0.5 * logvar) * enc_noise) * jm.cfg.scale_factor, 2)
        z_noisy = q_sample(jm.sched, z0, t, noise)
        ctx = jnp.broadcast_to(params["null_context"], (gt.shape[0],)
                               + params["null_context"].shape)
        out = jm.apply_model(params, z_noisy, t, ctx, z_lq)
        l_simple = jnp.mean((out - noise) ** 2)
        img01 = jnp.clip((jm.decode(vp, predict_start_from_noise(jm.sched, z_noisy, t, out))
                          + 1.0) / 2.0, 0.0, 1.0)
        l_pixel = jm.cfg.pixel_weight * jnp.mean(jnp.abs(img01 - batch["gt"]))
        l_ss, l_kl = jssl_loss(img01, batch["gt"], batch["gt_mask"], jm.ssl_setting)
        return {"l_simple": l_simple, "l_pixel": l_pixel, "l_selfsim": l_ss,
                "l_selfsim_kl": l_kl, "l_total": l_simple + l_pixel + l_ss + l_kl}

    def nhwc(x):
        return jnp.asarray(x.numpy().transpose(0, 2, 3, 1))
    ref = jax_logs(params, vp, b, jnp.asarray(draws["t"].numpy(), jnp.int32),
                   nhwc(draws["noise"]), nhwc(draws["enc_noise"]))
    state, logs = tm.train_step(state, torch_batch(b), draws)
    assert sorted(logs) == sorted(ref)
    for k, r in ref.items():
        assert abs(float(logs[k]) - float(r)) <= 3e-2 * abs(float(r)), (k, float(logs[k]), float(r))
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in trainable(state.params))
    moments = [v for s in state.opt.state.values() for v in s.values() if v.dim()]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    assert all(p.dtype == torch.float32 for p in trainable(state.ema_params))


def test_bf16_denoising_step_matches_jax():
    """One spaced-DDPM step (the struct-cond encoder, the UNet, the posterior
    mean) in bf16 from JAX's start latent: the latent within 3e-2 of its
    largest value (measured 1.9e-3)."""
    jm, tm, state, params, _ = _bf16_models()
    rng = np.random.RandomState(4)
    z_lq = rng.randn(1, 16, 16, 4).astype(np.float32)
    ctx = params["null_context"][None]
    key = jax.random.PRNGKey(5)

    def run(rng_key, c, zl):
        def apply(x, t, c_, zl_):
            return jm.apply_model(params, x, t, c_, zl_)
        return jsampler.spaced_ddpm_sample(apply, jm.sched, zl.shape, rng_key, c, zl, steps=1)
    ref = jax.jit(run)(key, ctx, z_lq)
    x_init = nchw(jax.random.normal(jax.random.split(key)[1], z_lq.shape))
    p = tm.infer_params(state)
    with torch.no_grad():
        got = sampler.spaced_ddpm_sample(
            lambda x, t, c, zl: tm.apply_model(p, x, t, c, zl), tm.sched, x_init.shape, None,
            torch.from_numpy(ctx), nchw(z_lq), steps=1, x_init=x_init, noises=[])
    assert got.dtype == torch.float32
    assert scaled_err(got, ref) < BOUND


def test_bf16_config_plumbing():
    """tests/test_diffusion.py::test_diffusion_bf16_config_plumbing on the
    port: model.compute_dtype fans out to the UNet, the struct-cond encoder
    and the VAE's encoder and decoder, a component's own key wins, and the
    parameters stay float32."""
    cfg = {"model": {"compute_dtype": BF16, "context_dim": 32,
                     "unet": {"model_channels": 32, "num_res_blocks": 1, "channel_mult": (1, 2),
                              "attention_resolutions": (2,), "num_heads": 4,
                              "num_head_channels": -1, "semb_channels": 32},
                     "structcond": {"model_channels": 32, "channel_mult": (1, 2),
                                    "out_channels": 32, "num_res_blocks": 1},
                     "first_stage": {"ch": 16, "ch_mult": (1, 2), "num_res_blocks": 1,
                                     "embed_dim": 4}},
           "sslopt": {}, "train": {}}
    model = build_from_config(cfg)
    nets = (model.unet, model.structcond, model.vae.encoder, model.vae.decoder)
    assert [n.dtype for n in nets] == [torch.bfloat16] * 4
    assert all(p.dtype == torch.float32 for n in nets for p in n.parameters())
    cfg["model"]["unet"]["compute_dtype"] = "float32"
    model = build_from_config(cfg)
    assert model.unet.dtype is None and model.structcond.dtype == torch.bfloat16
    cfg["model"]["compute_dtype"] = "float16"
    with pytest.raises(NotImplementedError, match="compute_dtype='float16'"):
        build_from_config(cfg)


# The bf16 splits fwd_plan and bwd_plan give on 132 SMs, by (path, case)
FWD_SPLITS_BF16 = {
    ("serve", "unet_ds1"): 1, ("serve", "struct_ds1"): 1, ("serve", "unet_ds2"): 2,
    ("serve", "struct_ds2"): 4, ("serve", "vae_mid"): 2, ("serve", "large_logits"): 8,
    ("train", "unet_ds1"): 1, ("train", "struct_ds1"): 1, ("train", "unet_ds2"): 1,
    ("train", "struct_ds2"): 2, ("train", "vae_mid"): 1, ("train", "large_logits"): 8,
}
BWD_SPLITS_BF16 = {"unet_ds1": (1, 1), "struct_ds1": (1, 1), "unet_ds2": (1, 1),
                   "struct_ds2": (2, 2), "vae_mid": (1, 1), "large_logits": (4, 4)}


@pytest.mark.parametrize("path,case", sorted(FWD_SPLITS_BF16))
def test_bf16_launch_geometry(path, case):
    """fwd_plan and bwd_plan for bf16 inputs: the bf16 kernels by name, the
    forward's occupancy (one block of 384 threads an SM; 128 queries and
    128-key tiles at d = 64 and 128, 64 and 64 at d = 512) and the backward's
    (one block of 384 threads an SM, 64-row tiles), grids that fill at least
    90% of 132 SMs' slots or cannot split further, and at d = 512 the P and
    dS scratch in the inputs' type."""
    b, h, n, m, d = (CUDA_CASES if path == "serve" else TRAIN_CASES)[case][:5]
    split, scratch, kernels = attention_cuda.fwd_plan(b, h, n, m, d, 132, torch.bfloat16)
    rows, keys, per_sm = attention_cuda.FWD_TILES_BF16[d]
    blocks, tiles, slots = n // rows * b * h, m // keys, per_sm * 132
    assert tiles % split == 0 and split == FWD_SPLITS_BF16[path, case]
    assert (blocks * split >= 0.9 * slots or split == attention_cuda.FWD_MAX_SPLIT
            or tiles % (2 * split))
    assert scratch == (split * b * h * n * (d + 2) if split > 1 else 0)
    main = "flash_attn_fwd_d512_bf16" if d == 512 else "flash_attn_fwd_bf16"
    assert kernels == {main: 1, "flash_attn_fwd_combine_bf16": int(split > 1)}
    if path == "serve":
        return
    dkv, dq, scratch, kernels = attention_cuda.bwd_plan(b, h, n, m, d, 132, torch.bfloat16)
    assert all(k.endswith("_bf16") for k in kernels)
    if d == 512:
        assert (dkv, dq, scratch) == (1, 1, 2 * b * h * n * m)
        return
    assert (dkv, dq) == BWD_SPLITS_BF16[case]
    assert kernels["flash_attn_bwd_sum_bf16"] == 2 * (dkv > 1) + (dq > 1)


def test_bf16_kernel_inputs_are_checked():
    """The wrapper takes all-bf16 q, k, v (strided views included) and
    refuses a mix, o or dO of another type, and a float32 lse of the wrong
    type."""
    q, k, v = attention_inputs(1, 4, 512, 512, 64, 0.125, "qkv", 8.0, dtype=torch.bfloat16)
    attention_cuda.check_inputs(q, k, v)
    assert not v.is_contiguous()
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        attention_cuda.check_inputs(q, k.float(), v)
    lse = torch.zeros(1, 4, 512)
    attention_cuda.check_bwd_inputs(q, k, v, q, lse, q)
    with pytest.raises(TypeError, match="o must be torch.bfloat16"):
        attention_cuda.check_bwd_inputs(q, k, v, q.float(), lse, q)
    with pytest.raises(TypeError, match="lse must be torch.float32"):
        attention_cuda.check_bwd_inputs(q, k, v, q, lse.bfloat16(), q)
