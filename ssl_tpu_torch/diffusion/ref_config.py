"""Reference (OmegaConf ``target:``/``params:``) diffusion config adapter.

A copy of ``ssl_tpu/diffusion/ref_config.py`` (which is pure Python), so that
the port reads the reference's configs without importing the JAX package.
The reference trains through PyTorch-Lightning with OmegaConf configs
(Diffusion-Based-SR/main.py:26-127); shipped files:
  - configs/SSL/base.yaml                        (StableSR-SSL fine-tune)
  - configs/StableSRISSLStage1/*.yml             (stage-1: + SD-2.1 ckpt_path)
  - configs/autoencoder/autoencoder_kl_64x64x4_resi.yaml  (CFW decoder train)

``is_reference_schema`` detects the ``model.target`` layout and
``translate_reference_config`` lowers it to the native schema that
``ssl_tpu_torch.diffusion.main.build_from_config`` (``kind: ssl``) and
``ssl_tpu_torch.diffusion.cfw_train`` (``kind: cfw``) consume.  Only
declarative settings are mapped.  The translation is the JAX package's, key
for key, faults included: a CFW config gets ``gan_opt`` and
``net_d_init_iters`` but no ``network_d`` or perceptual term, so it trains on
the pixel L1 alone unless the caller adds them (ROADMAP.md, section 3)."""

from __future__ import annotations

import os
from typing import Any

# reference class path (the `target:`) -> native dataset registry name
_DATASET_TARGETS = {
    "TwoStageDegradation_Img_Mask_Dataset": "TwoStageDegradationImgMaskDataset",
    "TwoStageDegradation_DF2K_Dataset": "TwoStageDegradationDF2KDataset",
    "SingleImageNPDataset": "SingleImageDataset",
}

_UNET_FIELDS = ("in_channels", "out_channels", "model_channels", "num_res_blocks",
                "attention_resolutions", "channel_mult", "num_heads",
                "num_head_channels", "transformer_depth", "context_dim",
                "semb_channels", "use_flash_attention", "compute_dtype")
_STRUCT_FIELDS = ("in_channels", "model_channels", "out_channels", "num_res_blocks",
                  "attention_resolutions", "channel_mult", "num_heads",
                  "use_flash_attention", "compute_dtype")


def is_reference_schema(cfg: dict) -> bool:
    model = cfg.get("model")
    return isinstance(model, dict) and "target" in model


def _existing(path: Any) -> str | None:
    """Reference configs carry placeholder ('xxx') or machine-local ckpt
    paths; only keep ones that resolve here."""
    return path if isinstance(path, str) and os.path.exists(path) else None


def _filter(d: dict, fields) -> dict:
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in (d or {}).items() if k in fields}


def _translate_dataset(block: dict) -> dict:
    target = (block or {}).get("target", "")
    cls = target.rsplit(".", 1)[-1]
    params = dict((block or {}).get("params") or {})
    out = {"type": _DATASET_TARGETS.get(cls, cls)}
    out.update(params)
    return out


def translate_reference_config(cfg: dict) -> dict:
    """Lower a reference OmegaConf-schema dict to the native schema."""
    model = cfg["model"]
    target = model.get("target", "")
    mp = dict(model.get("params") or {})

    if target.rsplit(".", 1)[-1] == "AutoencoderKLResi":
        # CFW decoder training config -> CFWTrainModel opt (cfw_train.py)
        dd = mp.get("ddconfig") or {}
        loss_p = ((mp.get("lossconfig") or {}).get("params") or {})
        out = {
            "kind": "cfw",
            "vae": {
                "embed_dim": mp.get("embed_dim", 4),
                "ch": dd.get("ch", 128),
                "ch_mult": tuple(dd.get("ch_mult", (1, 2, 4, 4))),
                "num_res_blocks": dd.get("num_res_blocks", 2),
                "fusion_w": mp.get("fusion_w", 1.0),
                "num_fuse_block": dd.get("num_fuse_block", 2),
                # bf16 activations (dotted override, not a reference key)
                **({"compute_dtype": mp["compute_dtype"]}
                   if mp.get("compute_dtype") else {}),
            },
            "train": {
                "optim_g": {"type": "Adam", "lr": model.get("base_learning_rate", 5e-5)},
                "net_d_init_iters": loss_p.get("disc_start", 0),
                "gan_opt": {"type": "GANLoss", "gan_type": "vanilla",
                            "loss_weight": loss_p.get("disc_weight", 0.025)},
            },
            "path": {"pretrain_vae": _existing(mp.get("ckpt_path"))},
        }
        _translate_data_section(cfg, out)
        return out

    sslopt_ref = mp.get("sslopt") or {}
    issl = cfg.get("ISSL_loss") or {}
    unet_p = (mp.get("unet_config") or {}).get("params") or {}
    first_p = (mp.get("first_stage_config") or {}).get("params") or {}
    dd = first_p.get("ddconfig") or {}
    struct_p = (mp.get("structcond_stage_config") or {}).get("params") or {}

    out: dict = {
        "kind": "ssl",
        "model": {
            "timesteps": mp.get("timesteps", 1000),
            "linear_start": mp.get("linear_start", 0.00085),
            "linear_end": mp.get("linear_end", 0.012),
            "parameterization": mp.get("parameterization", "eps"),
            "scale_factor": mp.get("scale_factor", 0.18215),
            "context_dim": unet_p.get("context_dim", 1024),
            "unet": _filter(unet_p, _UNET_FIELDS),
            "structcond": _filter(struct_p, _STRUCT_FIELDS),
            "first_stage": {
                "embed_dim": first_p.get("embed_dim", 4),
                "ch": dd.get("ch", 128),
                "ch_mult": tuple(dd.get("ch_mult", (1, 2, 4, 4))),
                "num_res_blocks": dd.get("num_res_blocks", 2),
            },
            "vae_ckpt": _existing(first_p.get("ckpt_path")),
            # stage-1 flow: model.params.ckpt_path = SD 2.1 full checkpoint
            # (configs/StableSRISSLStage1) -> UNet import
            "ckpt_path": _existing(mp.get("ckpt_path")),
            # bf16 activations, not a reference key — reachable from a
            # reference-schema file via a dotted CLI override
            # (model.params.compute_dtype=bfloat16); fans out to all three
            # networks in build_from_config
            **({"compute_dtype": mp["compute_dtype"]}
               if mp.get("compute_dtype") else {}),
        },
        "sslopt": {
            # reference key names (configs/SSL/base.yaml:30-39)
            "mask_stride": sslopt_ref.get("mask_stride", 3),
            "kernel_size_search": sslopt_ref.get("kernel_size", 25),
            "sigma": sslopt_ref.get("scaling_factor", 0.004),
            "kernel_size_window": sslopt_ref.get("kernel_size_center", 9),
            "generalization": bool(sslopt_ref.get("softmax_sr", True)),
            "l1_weight": (issl.get("selfsim_opt") or {}).get("loss_weight", 0.5),
            "kl_weight": (issl.get("selfsim1_opt") or {}).get("loss_weight", 0.5),
            # strategy-zoo passthrough: non-default strategies route through
            # losses/simself_strategies.py (exact issl composition)
            "simself_strategy": sslopt_ref.get("simself_strategy", ""),
            **{k: sslopt_ref[k] for k in
               ("simself_dh", "simself_dw", "kernel_size", "scaling_factor",
                "softmax_sr", "softmax_gt", "temperature", "crossentropy",
                "rearrange_back", "kernel_size_center", "mean", "var",
                "gene_type", "largest_k") if k in sslopt_ref},
        },
        "degradation": dict(cfg.get("degradation") or {}),
        "train": {
            "lr": model.get("base_learning_rate", 5e-5),
        },
    }

    lightning = cfg.get("lightning") or {}
    trainer = lightning.get("trainer") or {}
    out["train"]["max_steps"] = trainer.get("max_steps", 800000)
    out["train"]["accumulate_grad_batches"] = trainer.get("accumulate_grad_batches", 1)
    ckpt_cb = ((lightning.get("modelcheckpoint") or {}).get("params") or {})
    if "every_n_train_steps" in ckpt_cb:
        out["train"]["save_every"] = ckpt_cb["every_n_train_steps"]

    _translate_data_section(cfg, out)
    return out


def _translate_data_section(cfg: dict, out: dict) -> None:
    data_p = (cfg.get("data") or {}).get("params") or {}
    train_ds = _translate_dataset(data_p.get("train"))
    gt_size = train_ds.get("gt_size") or train_ds.get("crop_size") \
        or (cfg.get("degradation") or {}).get("gt_size", 512)
    out["data"] = {
        "batch_size": data_p.get("batch_size", 2),
        "num_workers": data_p.get("num_workers", 2),
        "crop_size": gt_size,
        "train": train_ds,
    }
    if "queue_size" in train_ds:
        out.setdefault("degradation", {})["queue_size"] = train_ds["queue_size"]
