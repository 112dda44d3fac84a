"""Pixel-space and distribution losses (reference: basicsr/losses/basic_loss.py).

Counterpart of the ``L1Loss`` and ``KLDistanceLoss`` of
``ssl_tpu/losses/basic_loss.py``: plain callables built from option dicts."""

from __future__ import annotations

import torch

from ssl_tpu_torch.losses.loss_util import weight_reduce_loss
from ssl_tpu_torch.utils.registry import LOSS_REGISTRY

_VALID_REDUCTIONS = ("none", "mean", "sum")


def _check_reduction(reduction):
    if reduction not in _VALID_REDUCTIONS:
        raise ValueError(f"Unsupported reduction mode: {reduction}. "
                         f"Supported ones are: {_VALID_REDUCTIONS}")


@LOSS_REGISTRY.register()
class L1Loss:
    def __init__(self, loss_weight=1.0, reduction="mean"):
        _check_reduction(reduction)
        self.loss_weight, self.reduction = loss_weight, reduction

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * weight_reduce_loss(torch.abs(pred - target), weight,
                                                     self.reduction)


@LOSS_REGISTRY.register()
class KLDistanceLoss:
    """KL divergence between SSG rows (reference basic_loss.py:269-282):
    kl_div(clamp(x, 1e-10).log(), clamp(y, 1e-10)) with optional row softmax."""

    def __init__(self, loss_weight=0.1, reduction="mean", softmax=False):
        self.loss_weight, self.reduction, self.softmax = loss_weight, reduction, softmax

    def pointwise(self, x, y):
        if self.softmax:
            x = torch.softmax(x, dim=-1)
            y = torch.softmax(y, dim=-1)
        x = torch.clamp(x, min=1e-10)
        y = torch.clamp(y, min=1e-10)
        return y * (torch.log(y) - torch.log(x))

    def __call__(self, x, y):
        kld = self.pointwise(x, y)
        if self.reduction == "mean":
            kld = torch.mean(kld)
        elif self.reduction == "sum":
            kld = torch.sum(kld)
        return self.loss_weight * kld
