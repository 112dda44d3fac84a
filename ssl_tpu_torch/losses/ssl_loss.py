"""The SSL training penalty: L1 + KL between the SSGs of the SR output and GT.

Counterpart of ``ssl_tpu/losses/ssl_loss.py``.  The shipped ``impl: dense``
and ``impl: pallas`` compute the same function (``tests/test_ssg_pallas.py``)
and both go through ``ssl_loss_sums``: the K1 CUDA kernel for CUDA tensors,
its plain version for CPU tensors.

Reduction parity: the reference concatenates all per-image SSGs to
(1, N_total, search^2) and takes the mean over every element, so the sums
are divided by count * search^2 (+1e-12)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ssl_tpu_torch.ops.ssg import SSGConfig, apply_mask_stride
from ssl_tpu_torch.ops.ssg_cuda import ssl_loss_sums

_LATER = "queued in ROADMAP.md (SSG gather API and strategy zoo)"


class SSLSetting(NamedTuple):
    """Mirror of the YAML ``ssl_setting`` block + loss weights (the fields of
    ``ssl_tpu``'s ``SSLSetting`` that the ported paths read; the gather API's
    ``capacity`` and the strategy zoo's options are not ported)."""
    ssg: SSGConfig = SSGConfig()
    mask_stride: int = 0        # 0/1 = off (GAN-tree shipped behavior); >1 = diagonal lattice
    l1_weight: float = 1e3      # selfsim_opt loss_weight
    kl_weight: float = 1e3      # selfsim1_opt loss_weight
    kl_softmax: bool = False
    impl: str = "dense"         # 'dense' | 'pallas' (both K1 here) | 'scan' (not ported)
    strategy: str = ""          # diffusion-tree strategy zoo (not ported)


def ssl_setting_from_opt(opt: dict, train_opt: dict | None = None) -> SSLSetting:
    """Build from a reference-schema option dict.

    Keeps the reference's per-tree mask_stride behavior: the stride is
    *defined* in ``ssl_setting`` but *applied* only if ``train.mask_stride``
    (esrganssl_model.py:164 vs train_ESRGANSSL_bicubic_x4.yml:70), unless
    ``ssl_setting.apply_mask_stride: true`` forces it on.  The key
    ``pair_offsets`` is ignored: it re-orders the offset sweep of the JAX
    stored path exactly and changes no number."""
    s = opt.get("ssl_setting", {})
    ssg = SSGConfig(
        search=s.get("kernel_size_search", 25),
        window=s.get("kernel_size_window", 9),
        sigma=s.get("sigma", 0.004),
        generalization=s.get("generalization", True),
        q_store_dtype=s.get("q_store_dtype", "float32"),
        stream_dtype=s.get("stream_dtype", "float32"),
    )
    train_opt = train_opt or opt.get("train", {}) or {}
    stride = train_opt.get("mask_stride", 0)
    if s.get("apply_mask_stride", False):
        stride = s.get("mask_stride", 0)
    l1_w = kl_w = 0.0
    kl_sm = False
    if train_opt.get("selfsim_opt"):
        l1_w = train_opt["selfsim_opt"].get("loss_weight", 1.0)
    if train_opt.get("selfsim1_opt"):
        kl_w = train_opt["selfsim1_opt"].get("loss_weight", 1.0)
        kl_sm = train_opt["selfsim1_opt"].get("softmax", False)
    # reference-config compat: ssl_mode 'cuda'/'pytorch' both map to the exact
    # dense path unless an explicit impl is given
    impl = s.get("impl")
    if impl is None:
        impl = {"cuda": "dense", "pytorch": "dense"}.get(s.get("ssl_mode"), "dense")
    strategy = s.get("simself_strategy", "")
    if strategy in ("areaarea_mask_nonlocalavg_cuda_v1", "ssl_cuda"):
        strategy = ""
    return SSLSetting(ssg=ssg, mask_stride=int(stride), l1_weight=float(l1_w),
                      kl_weight=float(kl_w), kl_softmax=kl_sm, impl=impl, strategy=strategy)


def ssl_loss(sr: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor, setting: SSLSetting):
    """(l_selfsim, l_selfsim_kl) for a batch.

    sr, gt: NCHW (b, c, h, w) float32; mask: (b, 1, h, w) or (b, h, w) binary
    edge masks.  GT's SSG is a constant target."""
    if setting.strategy:
        raise NotImplementedError(f"ssl_setting.simself_strategy={setting.strategy!r}: {_LATER}")
    if setting.kl_softmax:
        raise NotImplementedError(f"selfsim1_opt.softmax: true: {_LATER}")
    if setting.impl not in ("dense", "pallas"):
        raise NotImplementedError(f"ssl_setting.impl={setting.impl!r}: {_LATER}")
    if mask.dim() == 4:
        mask = mask[:, 0]
    mask = apply_mask_stride(mask.to(sr.dtype), setting.mask_stride).contiguous()
    l1_sum, kl_sum, count = ssl_loss_sums(sr.contiguous(), gt.contiguous(), mask, setting.ssg)
    denom = count * (setting.ssg.search * setting.ssg.search) + 1e-12
    return l1_sum / denom * setting.l1_weight, kl_sum / denom * setting.kl_weight
