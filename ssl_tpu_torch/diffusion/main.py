"""Build the StableSR-SSL diffusion model from a configuration dict.

Counterpart of ``ssl_tpu/diffusion/main.py::build_from_config`` (the shipped
``options/diffusion/ssl_base.yml`` schema).  ``model.use_flash_attention``
fans out to the UNet, the struct-cond encoder and the VAE, as there.  Not
ported yet, and raising ``NotImplementedError``: ``compute_dtype`` (bf16
activations), ``parallel`` (data and tensor parallelism), reference-schema
configs (``model.target``), the SSL strategy zoo, and the checkpoint and
CLIP weight paths.  The training options come over as there: ``sslopt``
into the SSL setting (``mask_stride`` 3 by default; ``capacity``, the gather
API's, is read and ignored), ``train.lr`` and
``train.accumulate_grad_batches``.  The training CLI (``train``) waits for the
RealESRGAN data slice (ROADMAP.md, queue 1)."""

from __future__ import annotations

import torch

from ssl_tpu_torch.diffusion.ddpm_ssl import DiffusionSSLConfig, StableSRSSL
from ssl_tpu_torch.diffusion.unet import NOT_PORTED, EncoderUNetModelWT, UNetModelDualcondV2
from ssl_tpu_torch.diffusion.vae import AutoencoderKL
from ssl_tpu_torch.losses.ssl_loss import SSLSetting
from ssl_tpu_torch.ops.ssg import SSGConfig

# the fused SSL loss under the names the reference configs give it
DEFAULT_STRATEGIES = ("", "areaarea_mask_nonlocalavg_cuda_v1", "ssl_cuda")


def build_from_config(cfg: dict) -> StableSRSSL:
    model_cfg = cfg.get("model", {})
    if "target" in model_cfg:
        raise NotImplementedError(f"reference-schema configs (model.target) {NOT_PORTED}")
    if cfg.get("parallel"):
        raise NotImplementedError(f"parallel: {cfg['parallel']} {NOT_PORTED}")
    sslopt = cfg.get("sslopt", {})
    if sslopt.get("simself_strategy", "") not in DEFAULT_STRATEGIES:
        raise NotImplementedError(
            f"sslopt.simself_strategy={sslopt['simself_strategy']!r} {NOT_PORTED}")
    dcfg = DiffusionSSLConfig(
        timesteps=model_cfg.get("timesteps", 1000),
        beta_schedule=model_cfg.get("beta_schedule", "linear"),
        linear_start=model_cfg.get("linear_start", 0.00085),
        linear_end=model_cfg.get("linear_end", 0.012),
        parameterization=model_cfg.get("parameterization", "eps"),
        scale_factor=model_cfg.get("scale_factor", 0.18215),
        pixel_weight=model_cfg.get("pixel_weight", 0.1),
        ssl_l1_weight=sslopt.get("l1_weight", 0.5),
        ssl_kl_weight=sslopt.get("kl_weight", 0.5),
        context_dim=model_cfg.get("context_dim", 1024),
        context_len=model_cfg.get("context_len", 77),
    )
    unet_cfg = {k: v for k, v in model_cfg.get("unet", {}).items() if k != "context_dim"}
    vae_cfg = dict(model_cfg.get("first_stage", {}))
    struct_cfg = dict(model_cfg.get("structcond") or {
        "model_channels": unet_cfg.get("model_channels", 256),
        "channel_mult": tuple(unet_cfg.get("channel_mult", (1, 1, 2, 2)))})
    for key in ("use_flash_attention", "compute_dtype"):
        if model_cfg.get(key):
            for c in (unet_cfg, vae_cfg, struct_cfg):
                c.setdefault(key, model_cfg[key])
    with torch.device("meta"):      # definitions only: init_state makes the weights
        unet = UNetModelDualcondV2(context_dim=dcfg.context_dim, **unet_cfg)
        structcond = EncoderUNetModelWT(**struct_cfg)
        vae = AutoencoderKL(**vae_cfg)
    ssg = SSGConfig(search=sslopt.get("kernel_size_search", 25),
                    window=sslopt.get("kernel_size_window", 9),
                    sigma=sslopt.get("sigma", 0.004),
                    generalization=sslopt.get("generalization", True))
    setting = SSLSetting(ssg=ssg, mask_stride=sslopt.get("mask_stride", 3),
                         l1_weight=dcfg.ssl_l1_weight, kl_weight=dcfg.ssl_kl_weight,
                         impl=sslopt.get("impl", "dense"))
    train = cfg.get("train", {})
    return StableSRSSL(
        dcfg, unet=unet, structcond=structcond, vae=vae, ssl_setting=setting,
        lr=train.get("lr", 5e-5), accumulate=train.get("accumulate_grad_batches", 1),
        vae_ckpt=model_cfg.get("vae_ckpt"),
        clip_text_ckpt=model_cfg.get("clip_text_ckpt"),
        text_prompt=model_cfg.get("text_prompt"),
        unet_ckpt=model_cfg.get("ckpt_path") or model_cfg.get("unet_ckpt"))
