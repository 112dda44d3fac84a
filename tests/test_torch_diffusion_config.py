"""The port's diffusion build_from_config on the shipped config, against ssl_tpu's.

``build_from_config`` defines the networks on the meta device (shapes, no
memory), so the full-width ``options/diffusion/ssl_base.yml`` model is
cheap to build here, and a forward (or a training mini-step) on meta
tensors counts the attention calls of one serving request (or one mini-step)
at 512^2 without computing them."""

import os
import sys

import optax
import pytest
import torch
import yaml

from ssl_tpu.diffusion.main import build_from_config as jax_build
from ssl_tpu_torch.diffusion import ddpm_ssl, unet, vae
from ssl_tpu_torch.diffusion.main import build_from_config
from ssl_tpu_torch.ops import attention, attention_cuda

SSL_BASE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "options", "diffusion", "ssl_base.yml")


def shipped(**model):
    with open(SSL_BASE) as f:
        cfg = yaml.safe_load(f)
    cfg["model"].update(model)
    return cfg


def test_shipped_config_builds_what_jax_builds():
    cfg = shipped(use_flash_attention=True)
    got, ref = build_from_config(cfg), jax_build(cfg)
    assert got.cfg._asdict() == ref.cfg._asdict()
    assert got.use_ema == ref.use_ema
    assert ref.unet.use_flash_attention and ref.structcond.use_flash_attention
    assert ref.vae.use_flash_attention
    # num_head_channels 64 wins over num_heads 8: 4, 8 and 16 heads of 64
    heads = sorted({(m.heads, m.dim_head) for m in got.unet.modules()
                    if isinstance(m, unet.CrossAttention)})
    assert heads == [(4, 64), (8, 64), (16, 64)]
    assert [ref.unet._heads(c) for c in (256, 512, 1024)] == [(4, 64), (8, 64), (16, 64)]
    struct_heads = {m.num_heads for m in got.structcond.modules()
                    if isinstance(m, unet.AttentionBlockQKV)}
    assert struct_heads == {ref.structcond.num_heads} == {4}
    flags = [m.use_flash_attention for net in (got.unet, got.structcond, got.vae)
             for m in net.modules() if hasattr(m, "use_flash_attention")]
    assert len(flags) == 2 * 16 + 7 + 2 and all(flags)   # 16 transformers, 7 QKV blocks, 2 VAE
    assert all(p.is_meta for p in got.unet.parameters())


def test_k2_calls_per_denoising_step_and_per_request(monkeypatch):
    """14 eligible attention calls per denoising step, 2 per request (the
    VAE's encoder and decoder mid-blocks), at the shapes of the kernel
    table in PERF.md.  The device test is lifted and the kernel's wrapper
    replaced by a recorder, so the routing runs as on the card."""
    calls = []

    def record(q, k, v, sm_scale):
        calls.append((q.shape[0], q.shape[2], q.shape[1], k.shape[1], q.shape[3], sm_scale))
        return torch.empty_like(q)

    rule = attention.flash_eligible
    monkeypatch.setattr(attention, "flash_eligible", lambda n, m, f, _d: rule(n, m, f, "cuda"))
    monkeypatch.setattr("ssl_tpu_torch.ops.attention_cuda.flash_attn_fwd_cuda", record)
    model = build_from_config(shipped(use_flash_attention=True))
    with torch.device("meta"), torch.no_grad():
        z = model.encode(model.vae, torch.empty(1, 3, 512, 512), noise=torch.empty(1, 4, 64, 64))
        per_request = list(calls)
        calls.clear()
        model.apply_model({"unet": model.unet, "structcond": model.structcond}, z,
                          torch.zeros(1, dtype=torch.long), torch.empty(1, 77, 1024), z)
        per_step = list(calls)
        calls.clear()
        model.decode(model.vae, z)
    per_request += calls
    assert per_request == [(1, 1, 4096, 4096, 512, 512 ** -0.5)] * 2
    shapes = sorted((b, h, n, m, d) for b, h, n, m, d, _ in per_step)
    assert shapes == sorted([(1, 4, 4096, 4096, 64)] * 7 + [(1, 8, 1024, 1024, 64)] * 5
                            + [(1, 4, 1024, 1024, 128)] * 2)
    assert sorted({s for *_, s in per_step}) == [0.125, 1.0]


def test_training_options_carry_over_as_in_jax():
    """sslopt into the SSL setting, train.lr and accumulate_grad_batches."""
    cfg = shipped()
    got, ref = build_from_config(cfg), jax_build(cfg)
    g, r = got.ssl_setting, ref.ssl_setting
    assert (g.mask_stride, g.l1_weight, g.kl_weight, g.impl) == (r.mask_stride, r.l1_weight,
                                                                 r.kl_weight, r.impl) == (
                                                                     3, 0.5, 0.5, "dense")
    assert (g.ssg.search, g.ssg.window, g.ssg.sigma, g.ssg.generalization) == (
        r.ssg.search, r.ssg.window, r.ssg.sigma, r.ssg.generalization) == (25, 9, 0.004, True)
    assert (got.lr, got.accumulate) == (cfg["train"]["lr"], cfg["train"]["accumulate_grad_batches"])
    assert got.accumulate == 12 and isinstance(ref.tx, optax.MultiSteps)
    assert (got.use_ema, got.ema_decay) == (ref.use_ema, ref.ema_decay)
    # zero without a distributed mesh lays nothing out, as the JAX place_state
    assert not ddpm_ssl.StableSRSSL(zero=True).distributed


def test_k2_calls_per_training_mini_step(monkeypatch):
    """One mini-step at 512^2, batch 2, flash switch on: 17 K2 forward
    launches (the UNet's 10 and the struct-cond encoder's 4 with lse for the
    backward, the no-grad VAE encoder's 1 over [gt; lq], the decoder's mid
    attention 1 and its replay under remat 1) and 15 backward calls (each
    launching dkv and dq), and one K1 call.  The wrappers are replaced by
    recorders, so the routing runs as on the card; the first mini-step of 12
    applies no update, so the meta tensors never meet the optimizer."""
    fwd, bwd, k1 = [], [], []

    def record_fwd(q, k, v, sm_scale, return_lse=False):
        fwd.append((q.shape[0], q.shape[2], q.shape[1], k.shape[1], q.shape[3], return_lse))
        o = torch.empty(q.shape, device=q.device)
        return (o, torch.empty((q.shape[0], q.shape[2], q.shape[1]), device=q.device)) \
            if return_lse else o

    def record_bwd(q, k, v, o, lse, do, sm_scale):
        bwd.append((q.shape[0], q.shape[2], q.shape[1], k.shape[1], q.shape[3]))
        return tuple(torch.empty(t.shape, device=t.device) for t in (q, k, v))

    def record_k1(sr, gt, mask, cfg, stored):
        k1.append(tuple(sr.shape))
        zero = (sr * 0).sum()
        return zero, zero, torch.ones((), device=sr.device)

    rule = attention.flash_eligible
    monkeypatch.setattr(attention, "flash_eligible", lambda n, m, f, _d: rule(n, m, f, "cuda"))
    monkeypatch.setattr(attention_cuda, "flash_attn_fwd_cuda", record_fwd)
    monkeypatch.setattr(attention_cuda, "flash_attn_bwd_cuda", record_bwd)
    monkeypatch.setattr(sys.modules["ssl_tpu_torch.losses.ssl_loss"], "ssl_loss_sums", record_k1)
    model = build_from_config(shipped(use_flash_attention=True))
    with torch.device("meta"):
        params = {"unet": model.unet, "structcond": model.structcond,
                  "null_context": torch.empty(77, 1024, requires_grad=True)}
        state = ddpm_ssl.DiffusionState(step=0, params=params,
                                        frozen={"vae": model.vae.requires_grad_(False)})
        batch = {"gt": torch.empty(2, 3, 512, 512), "lq": torch.empty(2, 3, 512, 512),
                 "gt_mask": torch.empty(2, 1, 512, 512)}
        draws = {"enc_noise": torch.empty(4, 4, 64, 64), "t": torch.zeros(2, dtype=torch.long),
                 "noise": torch.empty(2, 4, 64, 64)}
        state, logs = model.train_step(state, batch, draws)
    assert state.mini_step == 1 and "l_selfsim" in logs
    assert k1 == [(2, 3, 512, 512)]
    shapes = [(1, 4, 4096, 4096, 64)] * 7 + [(1, 8, 1024, 1024, 64)] * 5 + \
        [(1, 4, 1024, 1024, 128)] * 2
    with_grad = sorted((2, *s[1:]) for s in shapes)
    assert sorted(f[:5] for f in fwd if f[5]) == sorted(with_grad + [(2, 1, 4096, 4096, 512)] * 2)
    assert [f[:5] for f in fwd if not f[5]] == [(4, 1, 4096, 4096, 512)]
    assert sorted(bwd) == sorted(with_grad + [(2, 1, 4096, 4096, 512)])
    assert (len(fwd), len(bwd)) == (17, 15)


@pytest.mark.parametrize("change", [
    {"compute_dtype": "float16"},        # bfloat16 is ported: tests/test_torch_diffusion_bf16.py
    {"target": "ldm.models.diffusion.ddpmssl.LatentDiffusionSRTextWTSSL"},
    {"vae_ckpt": "vae.ckpt"},
    {"clip_text_ckpt": "clip.bin"},
])
def test_unported_model_options_raise(change):
    """float16 and the CLIP text weights are not ported.  A reference-schema
    model (``model.target``) translates through diffusion/ref_config.py and
    builds what JAX builds (tests/test_torch_ref_config.py); a ``vae_ckpt``
    imports at init_state, where a missing file raises FileNotFoundError
    before any weight is made."""
    if "target" in change:
        got, ref = build_from_config(shipped(**change)), jax_build(shipped(**change))
        assert got.cfg._asdict() == ref.cfg._asdict()
        return
    if "vae_ckpt" in change:
        model = build_from_config(shipped(**change))
        assert model.vae_ckpt == "vae.ckpt"
        with pytest.raises(FileNotFoundError):
            model.init_state(device="cpu")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_from_config(shipped(**change))


def test_unported_top_level_options_raise():
    """``parallel`` beyond one rank needs a torchrun world of its size; a zoo
    strategy with its options builds the SSL setting the JAX package builds
    (capacity 2048 by default)."""
    cfg = shipped()
    cfg["parallel"] = {"data": 2, "tp": 2}
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        build_from_config(cfg)
    cfg = shipped()
    cfg["sslopt"].update(simself_strategy="areaarea_mask_nonlocal", kernel_size=7,
                         kernel_size_center=3, softmax_sr=True, simself_dh=8)
    got, ref = build_from_config(cfg).ssl_setting, jax_build(cfg).ssl_setting
    assert got.strategy == ref.strategy == "areaarea_mask_nonlocal"
    assert got.strategy_opts == ref.strategy_opts and len(got.strategy_opts) == 4
    assert got.capacity == ref.capacity == 2048
    for field in ("mask_stride", "l1_weight", "kl_weight", "kl_softmax", "impl"):
        assert getattr(got, field) == getattr(ref, field), field
    assert tuple(got.ssg) == tuple(getattr(ref.ssg, f) for f in got.ssg._fields)


def test_entry_points_target_cuda_by_default(monkeypatch):
    """No silent CPU run: without a card the default device fails; the
    train step and the preview are entry points like the samplers."""
    model = build_from_config(shipped())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.init_state(seed=0)
    assert callable(model.make_train_step()) and callable(model.make_preview())


def test_init_state_on_cpu_keeps_the_zero_layers_and_copies_the_ema():
    model = ddpm_ssl.StableSRSSL(
        ddpm_ssl.DiffusionSSLConfig(timesteps=20, context_dim=32, context_len=4),
        unet=unet.UNetModelDualcondV2(model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
                                      attention_resolutions=(2,), num_head_channels=16,
                                      context_dim=32, semb_channels=32),
        structcond=unet.EncoderUNetModelWT(model_channels=32, channel_mult=(1, 2),
                                           out_channels=32, num_res_blocks=1, num_heads=2),
        vae=vae.AutoencoderKL(ch=16, ch_mult=(1, 2), num_res_blocks=1))
    state = model.init_state(seed=0, device="cpu")
    net = state.params["unet"]
    assert not net.out[2].weight.any()
    assert net.input_blocks[1][0].in_layers[2].weight.all()
    ema = model.infer_params(state)
    assert ema is state.ema_params and ema["unet"] is not net
    for a, b in zip(net.parameters(), ema["unet"].parameters()):
        assert torch.equal(a, b)
    again = model.init_state(seed=0, device="cpu")
    assert torch.equal(again.params["null_context"], state.params["null_context"])


def test_chip_smoke_carries_the_shipped_config():
    """chip_smoke.py holds ssl_base.yml as a dict (the card's machine has no
    yaml); it must stay the shipped file, with the flash switch on: the
    model, the SSL options and the training options its train phases run."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(SSL_BASE), "..", "..", "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = shipped(use_flash_attention=True)
    carried = chip_smoke.ssl_base_cfg()
    assert carried == {k: cfg[k] for k in ("model", "sslopt", "train")}
