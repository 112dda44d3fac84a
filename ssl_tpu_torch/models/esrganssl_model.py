"""ESRGAN-SSL — the canonical SSL training recipe
(reference: models/esrganssl_model.py:18-540).

Counterpart of ``ssl_tpu/models/esrganssl_model.py``.  G losses: weighted
pixel L1 + SSG-L1 + SSG-KL + VGG perceptual + relativistic GAN; alternating
D; EMA.  The SSL term runs through the K1 kernel on CUDA tensors."""

from __future__ import annotations

from ssl_tpu_torch.losses.ssl_loss import ssl_loss, ssl_setting_from_opt
from ssl_tpu_torch.models.srgan_model import ESRGANModel
from ssl_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class ESRGANSSLModel(ESRGANModel):

    def __init__(self, opt: dict, device=None):
        super().__init__(opt, device=device)
        gt_size = ((opt.get("datasets") or {}).get("train") or {}).get("gt_size")
        self.ssl_setting = ssl_setting_from_opt(opt, gt_size=gt_size)
        self.use_ssl = bool(opt.get("ssl_setting")) and (
            self.ssl_setting.l1_weight > 0 or self.ssl_setting.kl_weight > 0)

    def g_losses(self, state, batch):
        total, logs, sr = super().g_losses(state, batch)
        if self.use_ssl and "gt_mask" in batch:
            l_selfsim, l_selfsim_kl = ssl_loss(sr, batch["gt"], batch["gt_mask"], self.ssl_setting)
            if self.ssl_setting.l1_weight > 0:
                total = total + l_selfsim
                logs["l_selfsim"] = l_selfsim
            if self.ssl_setting.kl_weight > 0:
                total = total + l_selfsim_kl
                logs["l_selfsim_kl"] = l_selfsim_kl
        return total, logs, sr
