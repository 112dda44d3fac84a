"""RankSRGAN-SSL: ESRGAN-SSL with a frozen Ranker's rank term
(reference: models/ranksrganssl_model.py:19-593).

Counterpart of ``ssl_tpu/models/ranksrganssl_model.py``.  The Ranker
(``network_r``, weights from seed + 2 or ``path.pretrain_network_r``) lives
in ``TrainState.extra["net_r"]`` in eval mode, its parameters frozen, and
goes into the training state with its running statistics.

The reference computes the rank score under ``no_grad`` (:191-198), a quirk
kept here: the rank term is added to the total and logged, but gives G no
gradient.

``Discriminator_VGG_296``'s first linear layer is sized from the train
set's ``gt_size`` (the crop it judges), as the JAX recipe infers it from
the GT shape at init."""

from __future__ import annotations

from copy import deepcopy

import torch

from ssl_tpu_torch.models.base_model import load_network
from ssl_tpu_torch.models.esrganssl_model import ESRGANSSLModel
from ssl_tpu_torch.utils.registry import MODEL_REGISTRY, build_network


@MODEL_REGISTRY.register()
class RankSRGANSSLModel(ESRGANSSLModel):

    def __init__(self, opt: dict, device=None):
        super().__init__(opt, device=device)
        rank_opt = (opt.get("train") or {}).get("rank_opt") or {}
        self.rank_weight = rank_opt.get("loss_weight", 0.0)
        self.rank_bias = rank_opt.get("R_bias", 0.0)

    def build_d(self, net_opt: dict, seed: int):
        if net_opt["type"] == "Discriminator_VGG_296":
            gt_size = ((self.opt.get("datasets") or {}).get("train") or {}).get("gt_size", 128)
            net_opt = dict(net_opt, input_size=gt_size)
        return super().build_d(net_opt, seed)

    def init_state(self, seed: int = 0):
        state = super().init_state(seed)
        if self.opt.get("network_r"):
            net_r = build_network(deepcopy(self.opt["network_r"]))
            net_r.reset_parameters(torch.Generator().manual_seed(seed + 2))
            path = (self.opt.get("path") or {}).get("pretrain_network_r")
            if path:
                load_network(net_r, path)
            state.extra = {"net_r": net_r.to(self.device).eval().requires_grad_(False)}
        return state

    def g_losses(self, state, batch):
        total, logs, sr = super().g_losses(state, batch)
        if state.extra and "net_r" in state.extra and self.rank_weight > 0:
            with torch.no_grad():
                score = state.extra["net_r"](sr)
            l_g_rank = self.rank_weight * torch.sum(torch.sigmoid(score - self.rank_bias))
            total = total + l_g_rank
            logs["l_g_rank"] = l_g_rank
        return total, logs, sr
