"""Pixel-space and distribution losses (reference: basicsr/losses/basic_loss.py).

Counterpart of ``ssl_tpu/losses/basic_loss.py``: plain callables built from
option dicts.  Image tensors are NCHW here where the JAX package's are NHWC
(``WeightedTVLoss``, ``SSIMLoss``, the weight of a weighted reduction); the
losses on rows and logits (``CrossEntropyLoss``, ``CosineDistanceLoss``, the
KL losses) work on the last axis in both."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ssl_tpu_torch.losses.loss_util import reduce_loss, weight_reduce_loss
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
class MSELoss:
    def __init__(self, loss_weight=1.0, reduction="mean"):
        _check_reduction(reduction)
        self.loss_weight, self.reduction = loss_weight, reduction

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * weight_reduce_loss((pred - target) ** 2, weight, self.reduction)


@LOSS_REGISTRY.register()
class CharbonnierLoss:
    def __init__(self, loss_weight=1.0, reduction="mean", eps=1e-12):
        _check_reduction(reduction)
        self.loss_weight, self.reduction, self.eps = loss_weight, reduction, eps

    def __call__(self, pred, target, weight=None):
        loss = torch.sqrt((pred - target) ** 2 + self.eps)
        return self.loss_weight * weight_reduce_loss(loss, weight, self.reduction)


@LOSS_REGISTRY.register()
class WeightedTVLoss:
    """TV loss as the L1 of neighbour differences (reference basic_loss.py:132-158)."""

    def __init__(self, loss_weight=1.0, reduction="mean"):
        if reduction not in ("mean", "sum"):
            raise ValueError(f"Unsupported reduction mode: {reduction}. "
                             "Supported ones are: mean | sum")
        self.loss_weight, self.reduction = loss_weight, reduction
        self._l1 = L1Loss(loss_weight=1.0, reduction=reduction)

    def __call__(self, pred, weight=None):
        wy = None if weight is None else weight[:, :, :-1, :]
        wx = None if weight is None else weight[:, :, :, :-1]
        y_diff = self._l1(pred[:, :, :-1, :], pred[:, :, 1:, :], weight=wy)
        x_diff = self._l1(pred[:, :, :, :-1], pred[:, :, :, 1:], weight=wx)
        return self.loss_weight * (x_diff + y_diff)


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


@LOSS_REGISTRY.register()
class CrossEntropyLoss:
    """Mean negative log-likelihood of integer ``labels`` (n,) under
    ``logits`` (n, classes)."""

    def __init__(self, loss_weight=1.0):
        self.loss_weight = loss_weight

    def __call__(self, logits, labels):
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels.long()[:, None])
        return self.loss_weight * torch.mean(nll)


@LOSS_REGISTRY.register()
class SSIMLoss:
    """KAIR's SSIM loss (reference train_BSGRAN/models/loss_ssim.py, KAIR's
    ``G_lossfn_type: "ssim"``): an 11 x 11 Gaussian window (sigma 1.5) per
    channel with zero padding, C1 = 1e-4, C2 = 9e-4.  It returns the mean
    SSIM *value*, as the reference does (KAIR adds it to the G loss as it
    is)."""

    def __init__(self, loss_weight=1.0, window_size=11, sigma=1.5):
        self.loss_weight = loss_weight
        self.window_size = window_size
        coords = (torch.arange(window_size) - window_size // 2).float()
        g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
        g = g / g.sum()
        self._window2d = torch.outer(g, g)

    def _filt(self, x):
        c = x.shape[1]
        kern = self._window2d.to(x.device, x.dtype)[None, None].expand(c, 1, -1, -1)
        return F.conv2d(x, kern, padding=self.window_size // 2, groups=c)

    def __call__(self, pred, target, weight=None):
        mu1, mu2 = self._filt(pred), self._filt(target)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = self._filt(pred * pred) - mu1_sq
        sigma2_sq = self._filt(target * target) - mu2_sq
        sigma12 = self._filt(pred * target) - mu1_mu2
        c1, c2 = 0.01 ** 2, 0.03 ** 2
        ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / \
            ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
        return self.loss_weight * torch.mean(ssim_map)


@LOSS_REGISTRY.register()
class CosineDistanceLoss:
    """1 - cosine similarity on the last axis, averaged (reference
    diffusion-tree basic_loss.py:613-620); the norms' product is clamped at
    1e-8, as torch's ``cosine_similarity`` does."""

    def __init__(self, loss_weight=0.1):
        self.loss_weight = loss_weight

    def __call__(self, x, y):
        num = torch.sum(x * y, dim=-1)
        den = torch.clamp(torch.linalg.norm(x, dim=-1) * torch.linalg.norm(y, dim=-1), min=1e-8)
        return torch.mean(1.0 - num / den) * self.loss_weight


@LOSS_REGISTRY.register()
class BCELoss:
    """Binary cross-entropy on probabilities, log terms clamped at -100 as
    ``nn.BCELoss`` does (reference basic_loss.py:623-631)."""

    def __init__(self, loss_weight=0.1, reduction="mean"):
        self.loss_weight, self.reduction = loss_weight, reduction

    def __call__(self, x, y):
        bce = -(y * torch.clamp(torch.log(x), min=-100.0)
                + (1 - y) * torch.clamp(torch.log1p(-x), min=-100.0))
        return self.loss_weight * reduce_loss(bce, self.reduction)


@LOSS_REGISTRY.register()
class KLDistanceLoss1:
    """The log-target KL (reference basic_loss.py:648-661):
    kl_div(log clamp(x, 1e-25), log clamp(y, 1e-25), log_target=True)."""

    def __init__(self, loss_weight=0.1, reduction="mean", softmax=False):
        self.loss_weight, self.reduction, self.softmax = loss_weight, reduction, softmax

    def __call__(self, x, y):
        if self.softmax:
            x = torch.softmax(x, dim=-1)
            y = torch.softmax(y, dim=-1)
        logx = torch.log(torch.clamp(x, min=1e-25))
        logy = torch.log(torch.clamp(y, min=1e-25))
        return self.loss_weight * reduce_loss(torch.exp(logy) * (logy - logx), self.reduction)


@LOSS_REGISTRY.register()
class MaxDistanceLoss:
    """max |x - y|, divided by the element count under 'mean' (reference
    basic_loss.py:663-676: the reduction divides the maximum)."""

    def __init__(self, loss_weight=0.1, reduction="mean"):
        self.loss_weight, self.reduction = loss_weight, reduction

    def __call__(self, x, y):
        md = torch.max(torch.abs(x - y))
        if self.reduction == "mean":
            md = md / x.numel()
        return self.loss_weight * md


@LOSS_REGISTRY.register()
class SmoothL2Loss:
    """reference basic_loss.py:678-693: where(|d| > delta, d^2 / 2,
    |delta |d| - delta^2 / 2|), summed, and divided by the element count for
    'mean'.  As in the reference, ``loss_weight`` is kept but never applied."""

    def __init__(self, delta=0.1, loss_weight=1.0, reduction="mean"):
        self.delta, self.loss_weight, self.reduction = delta, loss_weight, reduction

    def __call__(self, x, y):
        d = x - y
        small = torch.abs(self.delta * torch.abs(d) - 0.5 * self.delta ** 2)
        total = torch.sum(torch.where(torch.abs(d) > self.delta, 0.5 * d ** 2, small))
        if self.reduction == "mean":
            total = total / x.numel()
        return total
