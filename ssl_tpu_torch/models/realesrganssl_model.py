"""RealESRGAN(-SSL) recipes: the blind two-stage degradation inside the step.

Counterpart of ``ssl_tpu/models/realesrganssl_model.py`` in its device mode
(``degradation_device: true``, as the shipped option file sets): the loader
gives GT crops, edge masks and per-item kernels; each step degrades the
batch on the card (``ops/degrade.py``), makes the USM-sharpened GT, passes
the pairs through the training-pair pool, then runs the recipe's step.

The state's ``extra`` holds what the JAX step keys off ``state.rng`` and
``TrainState.extra``: ``host_gen`` (a CPU generator: the per-batch choices),
``dev_gen`` (a generator on the model's device: the per-item values, noise
fields and the pool's permutation), and the pool: ``queue_ptr`` (a Python
int, so the fill test needs no device read) and ``queue_<key>`` buffers,
made at the first step.  The training state saves and restores them, so a
resumed run continues the pool and the draws.

With ``degradation_device: false`` (the JAX package's default) the host
degrader does that work instead, in ``prepare_batch`` before the step
(``data/realesr_degradation.py``, as ``ssl_tpu``'s ``prepare_batch``):
the degradation of the GT batch, a random crop of each pair to the train
set's ``gt_size``, the host pool and, with ``Use_sharpen``, USM.  Its two
streams (seeded from ``manual_seed``) and, with ``save_degradation_pool``,
the pool go into the training state (``host_state``)."""

from __future__ import annotations

import numpy as np
import torch

from ssl_tpu_torch.data.realesr_degradation import RealESRGANDegrader
from ssl_tpu_torch.losses.ssl_loss import ssl_loss
from ssl_tpu_torch.models.base_model import TrainState
from ssl_tpu_torch.models.esrganssl_model import ESRGANSSLModel
from ssl_tpu_torch.models.sr_model import SRModel
from ssl_tpu_torch.models.srgan_model import SRGANModel
from ssl_tpu_torch.ops.degrade import DegradeConfig, degrade_two_stage, draw_degradation
from ssl_tpu_torch.ops.img_process import usm_sharp
from ssl_tpu_torch.utils.registry import MODEL_REGISTRY

POOLED = ("lq", "gt", "gt_usm", "gt_mask")
KERNELS = ("kernel1", "kernel2", "sinc_kernel")


def queue_shuffle(extra: dict, batch: dict, qsize: int, perm: torch.Tensor | None) -> dict:
    """The reference's training-pair pool ``_dequeue_and_enqueue``
    (realesrganssl_model.py:326-367; ``ssl_tpu``'s ``_queue_shuffle_jit``):
    while the pool fills, the batch passes through and is stored at the
    pointer; once full, the pool is permuted by ``perm``, its first b slots
    become the batch and the incoming pairs take their place.  The pooled
    keys move together, so pairs stay pairs.  Updates ``extra`` in place
    and returns the batch to train on."""
    keys = [k for k in POOLED if k in batch]
    b = batch["lq"].shape[0]
    if qsize % b:
        raise ValueError(f"queue_size {qsize} must be divisible by the batch size {b} "
                         "(reference realesrganssl_model.py:334)")
    if "queue_ptr" not in extra:
        extra["queue_ptr"] = 0
        for k in keys:
            extra[f"queue_{k}"] = batch[k].new_zeros((qsize,) + tuple(batch[k].shape[1:]))
    ptr = extra["queue_ptr"]
    batch = dict(batch)
    if ptr < qsize:
        for k in keys:
            extra[f"queue_{k}"][ptr:ptr + b] = batch[k]
        extra["queue_ptr"] = ptr + b
        return batch
    for k in keys:
        shuffled = extra[f"queue_{k}"][perm]
        out = shuffled[:b].clone()
        shuffled[:b] = batch[k]
        extra[f"queue_{k}"] = shuffled
        batch[k] = out
    return batch


class _DegradationMixin:
    """The degradation, USM and pool in front of a recipe's step
    (``ssl_tpu``'s ``_DegradationMixin`` in device mode)."""

    def _init_degrader(self, opt: dict):
        self.degrade_cfg = DegradeConfig.from_opt(opt)
        self.queue_size = int(opt.get("queue_size", 180) or 0)
        self.l1_gt_usm = opt.get("l1_gt_usm", True)
        self.percep_gt_usm = opt.get("percep_gt_usm", True)
        self.gan_gt_usm = opt.get("gan_gt_usm", False)
        self.device_degrade = bool(opt.get("degradation_device", False))
        self.degrader = None
        if not self.device_degrade:
            # ssl_tpu/models/realesrganssl_model.py:87-109
            self.gt_size = ((opt.get("datasets") or {}).get("train") or {}).get("gt_size", 256)
            self.degrader = RealESRGANDegrader(
                opt, scale=opt.get("scale", 4), queue_size=opt.get("queue_size", 180),
                use_sharpen=opt.get("Use_sharpen") is not None,
                degradation_order=opt.get("degradation_order", "two"),
                seed=opt.get("manual_seed"))

    @property
    def degrades_on_host(self) -> bool:
        """The train CLI hands this model host batches (no card prefetch)."""
        return not self.device_degrade

    def init_state(self, seed: int = 0) -> TrainState:
        """The recipe's state, in device mode with the draws' generators
        seeded from ``manual_seed`` (host) and ``manual_seed + 1`` (device)
        in ``extra``."""
        state = super().init_state(seed)
        if self.is_train and self.device_degrade:
            base = int(self.opt.get("manual_seed", 0) or 0)
            state.extra = {"host_gen": torch.Generator().manual_seed(base),
                           "dev_gen": torch.Generator(self.device).manual_seed(base + 1)}
        return state

    def host_state(self) -> dict:
        """The host degrader's streams and, with ``save_degradation_pool``,
        its pool (ssl_tpu/models/realesrganssl_model.py:111-132)."""
        if self.degrader is None:
            return {}
        return self.degrader.get_state(with_pool=bool(self.opt.get("save_degradation_pool")))

    def set_host_state(self, hs: dict) -> None:
        if self.degrader is not None:
            self.degrader.set_state(hs)

    def prepare_batch(self, batch: dict) -> dict:
        """The train CLI's hook before each step (``ssl_tpu/train.py``).  In
        host mode, the JAX package's host ``feed_data``: the loader batch
        (GT, mask and kernels) degraded, cropped to ``gt_size``, passed
        through the pool (and sharpened with ``Use_sharpen``) on the host;
        returns CHW tensors ``gt``, ``lq``, ``gt_mask`` (and ``gt_usm``) on the
        host.  In device mode, and for a batch that has its LQ, the batch
        passes through."""
        if "lq" in batch or self.device_degrade:
            return batch
        host = {k: batch[k].cpu().numpy() for k in KERNELS}
        for k in ("gt", "gt_mask"):
            if k in batch:
                host[k] = batch[k].cpu().permute(0, 2, 3, 1).numpy()
        out = self.degrader(host | {"gt_size": self.gt_size})
        return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
                for k, v in out.items()}

    def draws(self, state: TrainState, batch: dict) -> dict:
        """The step's draws: the degradation's and, once the pool is full, its
        permutation."""
        extra = state.extra
        b, h = batch["gt"].shape[0], batch["gt"].shape[-1]
        out = {"degrade": draw_degradation(self.degrade_cfg, b, h, extra["host_gen"],
                                           extra["dev_gen"]), "perm": None}
        if self.queue_size > 0 and extra.get("queue_ptr", 0) >= self.queue_size:
            out["perm"] = torch.randperm(self.queue_size, generator=extra["dev_gen"],
                                         device=self.device)
        return out

    def degrade_batch(self, state: TrainState, batch: dict, draws: dict | None = None) -> dict:
        """Degrade the GT batch, add ``gt_usm`` where a loss targets it, and
        pass the pairs through the pool; returns the batch to train on."""
        if draws is None:
            draws = self.draws(state, batch)
        batch = {k: v for k, v in batch.items() if k not in KERNELS} | {
            "lq": degrade_two_stage(batch["gt"], batch["kernel1"], batch["kernel2"],
                                    batch["sinc_kernel"], self.degrade_cfg, draws["degrade"])}
        if (self.l1_gt_usm or self.percep_gt_usm or self.gan_gt_usm) and "gt_usm" not in batch:
            with torch.no_grad():
                batch["gt_usm"] = usm_sharp(batch["gt"])
        if self.queue_size > 0:
            batch = queue_shuffle(state.extra, batch, self.queue_size, draws["perm"])
        return batch

    def make_train_step(self):
        base = super().make_train_step()

        def step(state: TrainState, batch: dict, draws: dict | None = None):
            if "lq" not in batch:
                batch = self.degrade_batch(state, batch, draws)
            return base(state, batch)
        return step

    def train_step(self, state: TrainState, batch: dict, draws: dict | None = None):
        """One step on a GT + kernels batch (or an already paired one);
        ``draws`` (``draws()``'s layout) replaces the generators' draws."""
        if not self.device_degrade and "lq" not in batch:
            batch = self.prepare_batch(batch)
        return self.make_train_step()(state, self.to_device(batch), draws)


@MODEL_REGISTRY.register()
class RealESRGANModel(_DegradationMixin, SRGANModel):
    """RealESRGAN without SSL (reference realesrgan_model.py): the degradation
    and a non-relativistic GAN, as in the JAX package."""

    def __init__(self, opt: dict, device=None):
        super().__init__(opt, device=device)
        self._init_degrader(opt)


@MODEL_REGISTRY.register()
class RealESRGANSSLModel(_DegradationMixin, ESRGANSSLModel):
    """RealESRGAN + the SSL penalty (reference realesrganssl_model.py)."""

    def __init__(self, opt: dict, device=None):
        super().__init__(opt, device=device)
        self._init_degrader(opt)

    def g_losses(self, state: TrainState, batch: dict):
        """ESRGAN-SSL's G losses with the ``*_gt_usm`` switches: the pixel and
        perceptual losses may target the sharpened GT (reference :369-384);
        the SSL loss compares with the GT."""
        sr = state.net_g(batch["lq"])
        gt = batch["gt"]
        gt_usm = batch.get("gt_usm", gt)
        total = sr.new_zeros(())
        logs = {}
        if self.cri_pix is not None:
            l_pix = self.cri_pix(sr, gt_usm if self.l1_gt_usm else gt)
            total = total + l_pix
            logs["l_pix"] = l_pix
        if self.use_ssl and "gt_mask" in batch:
            l_ss, l_kl = ssl_loss(sr, gt, batch["gt_mask"], self.ssl_setting)
            if self.ssl_setting.l1_weight > 0:
                total = total + l_ss
                logs["l_selfsim"] = l_ss
            if self.ssl_setting.kl_weight > 0:
                total = total + l_kl
                logs["l_selfsim_kl"] = l_kl
        if self.cri_perceptual is not None:
            l_percep, l_style = self.cri_perceptual(sr, gt_usm if self.percep_gt_usm else gt)
            total = total + l_percep + l_style
            logs["l_percep"] = l_percep
        return total, logs, sr


@MODEL_REGISTRY.register()
class RealESRNetSSLModel(_DegradationMixin, SRModel):
    """The degradation + the pixel-only pretraining stage, as the JAX
    package defines it (SRModel's losses)."""

    def __init__(self, opt: dict, device=None):
        super().__init__(opt, device=device)
        self._init_degrader(opt)


@MODEL_REGISTRY.register()
class RealESRNetModel(_DegradationMixin, SRModel):
    """RealESRNet (reference realesrnet_model.py): the degradation, then
    pixel (and perceptual) losses against the USM-sharpened GT when
    ``l1_gt_usm``, no GAN and no SSL."""

    def __init__(self, opt: dict, device=None):
        super().__init__(opt, device=device)
        self._init_degrader(opt)

    def g_losses(self, state: TrainState, batch: dict):
        sr = state.net_g(batch["lq"])
        gt = batch.get("gt_usm", batch["gt"]) if self.l1_gt_usm else batch["gt"]
        total = sr.new_zeros(())
        logs = {}
        if self.cri_pix is not None:
            l_pix = self.cri_pix(sr, gt)
            total = total + l_pix
            logs["l_pix"] = l_pix
        if self.cri_perceptual is not None:
            l_percep, l_style = self.cri_perceptual(sr, gt)
            total = total + l_percep + l_style
            logs["l_percep"] = l_percep
        return total, logs, sr
