"""LDL-SSL: ESRGAN-SSL with LDL's artifact-map weighted L1
(reference: models/ldlssl_model.py:19-555, LDL method CVPR'22).

Counterpart of ``ssl_tpu/models/ldlssl_model.py``.  The artifact map
compares the output of G with the EMA's (the step's incoming EMA, under
``no_grad``); where G is worse than the EMA, the pixels weight an extra L1
(``artifacts_opt``) by the local variance of G's residual."""

from __future__ import annotations

import torch

from ssl_tpu_torch.losses.loss_util import get_refined_artifact_map
from ssl_tpu_torch.models.esrganssl_model import ESRGANSSLModel
from ssl_tpu_torch.utils.registry import MODEL_REGISTRY, build_loss


@MODEL_REGISTRY.register()
class LDLSSLModel(ESRGANSSLModel):

    def __init__(self, opt: dict, device=None):
        super().__init__(opt, device=device)
        train_opt = opt.get("train") or {}
        self.cri_artifacts = build_loss(train_opt["artifacts_opt"]) \
            if train_opt.get("artifacts_opt") else None
        self.ldl_ksize = train_opt.get("ldl_ksize", 7)

    def g_losses(self, state, batch):
        total, logs, sr = super().g_losses(state, batch)
        if self.cri_artifacts is not None and state.net_g_ema is not None:
            with torch.no_grad():
                sr_ema = state.net_g_ema(batch["lq"])
                pixel_weight = get_refined_artifact_map(batch["gt"], sr, sr_ema, self.ldl_ksize)
            l_g_artifacts = self.cri_artifacts(pixel_weight * sr, pixel_weight * batch["gt"])
            total = total + l_g_artifacts
            logs["l_g_artifacts"] = l_g_artifacts
        return total, logs, sr
