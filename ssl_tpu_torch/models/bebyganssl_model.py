"""BebyGAN-SSL: ESRGAN-SSL with the best-buddy L1 and the back-projection L1
(reference: models/bebyganssl_model.py:567-1113).

Counterpart of ``ssl_tpu/models/bebyganssl_model.py``."""

from __future__ import annotations

import torch

from ssl_tpu_torch.losses.bbl import back_projection_loss, best_buddy_pairs
from ssl_tpu_torch.models.esrganssl_model import ESRGANSSLModel
from ssl_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class BebyGANSSLModel(ESRGANSSLModel):

    def __init__(self, opt: dict, device=None):
        super().__init__(opt, device=device)
        train_opt = opt.get("train") or {}
        bb = train_opt.get("bbl_opt") or {}
        self.bbl_weight = bb.get("loss_weight", 1.0)
        self.bbl_alpha = bb.get("alpha", 1.0)
        self.bbl_beta = bb.get("beta", 1.0)
        self.bbl_ksize = bb.get("ksize", 3)
        self.bbl_stride = bb.get("stride", 3)
        self.bp_weight = (train_opt.get("back_projection_opt") or {}).get("loss_weight", 1.0)

    def g_losses(self, state, batch):
        total, logs, sr = super().g_losses(state, batch)
        if self.bbl_weight > 0:
            p1, sel = best_buddy_pairs(sr, batch["gt"], self.bbl_alpha, self.bbl_beta,
                                       self.bbl_ksize, self.bbl_stride)
            l_bbl = self.bbl_weight * torch.mean(torch.abs(p1 - sel))
            total = total + l_bbl
            logs["l_g_bbl"] = l_bbl
        if self.bp_weight > 0 and "lq" in batch:
            l_bp = self.bp_weight * back_projection_loss(sr, batch["lq"])
            total = total + l_bp
            logs["l_g_bp"] = l_bp
        return total, logs, sr


@MODEL_REGISTRY.register()
class BebyGANModel(BebyGANSSLModel):
    """Plain BebyGAN (reference bebygan_model.py:15): the same recipe with no
    ``ssl_setting``, so no SSL term."""
