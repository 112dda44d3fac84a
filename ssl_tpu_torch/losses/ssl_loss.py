"""The SSL training penalty: L1 + KL between the SSGs of the SR output and GT.

Counterpart of ``ssl_tpu/losses/ssl_loss.py``.  The shipped ``impl: dense``
and ``impl: pallas`` compute the same function (``tests/test_ssg_pallas.py``)
and both go through ``ssl_loss_sums``: the K1 CUDA kernel for CUDA tensors,
its plain version for CPU tensors.  ``impl: scan``, and any impl with
``selfsim1_opt.softmax: true``, take the gather route (``gather_route``): the
SSG rows at each image's first ``capacity`` edge pixels
(``ops/ssg.py::ssg_matrix``), as in JAX.  A ``simself_strategy`` other than
the shipped one goes to ``losses/simself_strategies.py``.

Reduction parity: the reference concatenates all per-image SSGs to
(1, N_total, search^2) and takes the mean over every element, so the sums
are divided by count * search^2 (+1e-12).  Under a process group the count
is that of the global batch, as in the JAX step, and each rank's term is
scaled by the ``data`` width, so that the mean of the ranks' terms (and of
their gradients, which DDP takes) is the global loss.

``impl: dense`` takes the JAX package's stored route or its batched route by
the same rule (``dense_route``), so that both packages compute the same
function at every shape: the routes differ only in their bf16 modes."""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ssl_tpu_torch.losses.basic_loss import KLDistanceLoss
from ssl_tpu_torch.ops.ssg import (BF16, SSGConfig, apply_mask_stride, mask_to_positions,
                                   ssg_matrix)
from ssl_tpu_torch.ops.ssg_cuda import ssl_loss_sums
from ssl_tpu_torch.parallel.mesh import global_sum

# the shipped strategy's names: the fused loss above, not the zoo
DEFAULT_STRATEGIES = ("", "areaarea_mask_nonlocalavg_cuda_v1", "ssl_cuda")
# the sslopt / ssl_setting keys of the strategy zoo's options
ZOO_KEYS = ("simself_dh", "simself_dw", "kernel_size", "scaling_factor",
            "softmax_sr", "softmax_gt", "temperature", "crossentropy",
            "rearrange_back", "kernel_size_center", "mean", "var",
            "gene_type", "largest_k")


class SSLSetting(NamedTuple):
    """Mirror of the YAML ``ssl_setting`` block + loss weights."""
    ssg: SSGConfig = SSGConfig()
    mask_stride: int = 0        # 0/1 = off (GAN-tree shipped behavior); >1 = diagonal lattice
    capacity: int = 4096        # per-image edge-pixel capacity of the gather route and zoo
    l1_weight: float = 1e3      # selfsim_opt loss_weight
    kl_weight: float = 1e3      # selfsim1_opt loss_weight
    kl_softmax: bool = False
    impl: str = "dense"         # 'dense' | 'pallas' (both K1 here) | 'scan' (gather)
    # the diffusion tree's strategy zoo (losses/simself_strategies.py): '' = the
    # shipped fused loss; any other reference strategy name routes there
    strategy: str = ""
    strategy_opts: tuple = ()   # frozen (key, value) pairs of ZOO_KEYS


def ssl_setting_from_opt(opt: dict, train_opt: dict | None = None,
                         gt_size: int | None = None) -> SSLSetting:
    """Build from a reference-schema option dict.

    Keeps the reference's per-tree mask_stride behavior: the stride is
    *defined* in ``ssl_setting`` but *applied* only if ``train.mask_stride``
    (esrganssl_model.py:164 vs train_ESRGANSSL_bicubic_x4.yml:70), unless
    ``ssl_setting.apply_mask_stride: true`` forces it on.  The bf16 knobs
    default to the environment's ``SSG_STORE_DTYPE`` / ``SSG_STREAM_DTYPE``,
    as in the JAX package.  ``capacity`` defaults to gt_size^2 // 3, else
    4096.  The key ``pair_offsets`` is ignored: it re-orders the float32 work
    of the JAX stored path."""
    s = opt.get("ssl_setting", {})
    ssg = SSGConfig(
        search=s.get("kernel_size_search", 25),
        window=s.get("kernel_size_window", 9),
        sigma=s.get("sigma", 0.004),
        generalization=s.get("generalization", True),
        q_store_dtype=s.get("q_store_dtype", os.environ.get("SSG_STORE_DTYPE", "float32")),
        stream_dtype=s.get("stream_dtype", os.environ.get("SSG_STREAM_DTYPE", "float32")),
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
    cap = s.get("capacity", (gt_size * gt_size) // 3 if gt_size else 4096)
    # reference-config compat: ssl_mode 'cuda'/'pytorch' both map to the exact
    # dense path unless an explicit impl is given
    impl = s.get("impl")
    if impl is None:
        impl = {"cuda": "dense", "pytorch": "dense"}.get(s.get("ssl_mode"), "dense")
    return SSLSetting(ssg=ssg, mask_stride=int(stride), capacity=int(cap),
                      l1_weight=float(l1_w), kl_weight=float(kl_w), kl_softmax=kl_sm,
                      impl=impl, strategy=zoo_strategy(s), strategy_opts=zoo_opts(s))


def zoo_strategy(s: dict) -> str:
    """The ``simself_strategy`` of an ``ssl_setting`` / ``sslopt`` block: ''
    for the shipped one (the fused loss), else the zoo's name."""
    strategy = s.get("simself_strategy", "")
    return "" if strategy in DEFAULT_STRATEGIES else strategy


def zoo_opts(s: dict) -> tuple:
    """The zoo's options of an ``ssl_setting`` / ``sslopt`` block, as frozen
    (key, value) pairs."""
    return tuple((k, s[k]) for k in ZOO_KEYS if k in s)


def q_store_bytes(b: int, h: int, w: int, cfg: SSGConfig) -> int:
    """Bytes of the stored route's q stack: search^2 x 2b x h x w values of
    ``q_store_dtype``."""
    return cfg.search * cfg.search * 2 * b * h * w * (2 if cfg.q_store_dtype == BF16 else 4)


def dense_route(b: int, h: int, w: int, cfg: SSGConfig) -> tuple:
    """The route of ``ssl_tpu/losses/ssl_loss.py``'s dense path: the stored
    q stack when its ``q_store_bytes`` fit in ``SSG_STORE_BYTES`` (default 2
    GiB), else the batched sweeps, where the store knob has no effect.
    Returns (stored, the config of that route)."""
    stored = q_store_bytes(b, h, w, cfg) <= int(os.environ.get("SSG_STORE_BYTES",
                                                               str(2 * 1024 ** 3)))
    return stored, cfg if stored else cfg._replace(q_store_dtype="float32")


def ssl_loss(sr: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor, setting: SSLSetting,
             mesh=None):
    """(l_selfsim, l_selfsim_kl) for a batch.

    sr, gt: NCHW (b, c, h, w) float32; mask: (b, 1, h, w) or (b, h, w) binary
    edge masks.  GT's SSG is a constant target.  ``mesh`` is the model's
    training mesh (``parallel/mesh.py``): when it is distributed the count
    is that of the global batch."""
    if setting.strategy:
        if mesh is not None and mesh.data > 1:
            raise NotImplementedError("a simself_strategy zoo loss over several data ranks is "
                                      "not ported yet (ROADMAP.md, queue 1 item 10)")
        from ssl_tpu_torch.losses.simself_strategies import simself_strategy_loss
        return simself_strategy_loss(sr, gt, mask, setting)
    if setting.kl_softmax or setting.impl not in ("dense", "pallas"):
        return gather_route(sr, gt, mask, setting, mesh)
    if setting.impl == "pallas" and BF16 in (setting.ssg.q_store_dtype,
                                             setting.ssg.stream_dtype):
        raise NotImplementedError("ssl_setting.impl='pallas' with the bf16 knobs (a float32 "
                                  "Pallas forward and a bf16-streaming backward in JAX): use "
                                  "impl: dense")
    if mask.dim() == 4:
        mask = mask[:, 0]
    mask = apply_mask_stride(mask.to(sr.dtype), setting.mask_stride).contiguous()
    stored, cfg = dense_route(*mask.shape, setting.ssg)
    l1_sum, kl_sum, count = ssl_loss_sums(sr.contiguous(), gt.contiguous(), mask, cfg, stored)
    count, scale = global_count(count, mesh)
    denom = count * (setting.ssg.search * setting.ssg.search) + 1e-12
    return (l1_sum / denom * setting.l1_weight * scale,
            kl_sum / denom * setting.kl_weight * scale)


def global_count(count: torch.Tensor, mesh):
    """(the count of the global batch, the scale of this rank's term): the
    count summed over ``mesh``'s ``data`` axis and its width when the mesh
    is distributed, else (``count``, 1)."""
    if mesh is None or not mesh.distributed:
        return count, 1
    return global_sum(count.detach(), mesh), mesh.data


def gather_route(sr: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor, setting: SSLSetting,
                 mesh=None):
    """(l_selfsim, l_selfsim_kl) through the gather API (``ssl_tpu``'s
    ``impl: scan`` path): the rows of SR and of GT (without grad) at each
    image's first ``capacity`` edge pixels, weighted by validity, the sums
    divided by sum(valid) * search^2 + 1e-12; the KL with its row softmax
    when ``kl_softmax``.  An image with more edge pixels than ``capacity``
    loses the rest, as in JAX."""
    if mask.dim() == 4:
        mask = mask[:, 0]
    mask = apply_mask_stride(mask, setting.mask_stride)
    pos, valid = zip(*(mask_to_positions(m, setting.capacity)[:2] for m in mask))
    pos, valid = torch.stack(pos), torch.stack(valid)
    q_sr = ssg_matrix(sr, pos, setting.ssg)
    with torch.no_grad():
        q_gt = ssg_matrix(gt, pos, setting.ssg)
    vmask = valid[..., None].to(sr.dtype)                     # (b, cap, 1)
    count, scale = global_count(torch.sum(vmask), mesh)
    denom = count * q_sr.shape[-1] + 1e-12
    l1 = torch.sum(torch.abs(q_sr - q_gt) * vmask) / denom * setting.l1_weight * scale
    kl_fn = KLDistanceLoss(loss_weight=1.0, reduction="none", softmax=setting.kl_softmax)
    kl = torch.sum(kl_fn.pointwise(q_sr, q_gt) * vmask) / denom * setting.kl_weight * scale
    return l1, kl
