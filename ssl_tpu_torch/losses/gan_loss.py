"""GAN losses: vanilla / lsgan / wgan / wgan_softplus / hinge, their
multiscale form, and feature matching.

Counterpart of ``ssl_tpu/losses/gan_loss.py``'s ``GANLoss``,
``MultiScaleGANLoss`` and ``GANFeatLoss`` (reference
basicsr/losses/gan_loss.py:10-140).  The relativistic composition lives in
the model recipes, as in the reference."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ssl_tpu_torch.utils.registry import LOSS_REGISTRY


@LOSS_REGISTRY.register()
class GANLoss:
    def __init__(self, gan_type="vanilla", real_label_val=1.0, fake_label_val=0.0,
                 loss_weight=1.0):
        if gan_type not in ("vanilla", "lsgan", "wgan", "wgan_softplus", "hinge"):
            raise NotImplementedError(f"GAN type {gan_type} is not implemented.")
        self.gan_type = gan_type
        self.real_label_val = real_label_val
        self.fake_label_val = fake_label_val
        self.loss_weight = loss_weight

    def _target(self, x, target_is_real):
        return torch.full_like(x, self.real_label_val if target_is_real else self.fake_label_val)

    def __call__(self, x, target_is_real: bool, is_disc: bool = False):
        if self.gan_type == "vanilla":
            # stable BCE-with-logits against constant labels
            loss = F.binary_cross_entropy_with_logits(x, self._target(x, target_is_real))
        elif self.gan_type == "lsgan":
            loss = torch.mean((x - self._target(x, target_is_real)) ** 2)
        elif self.gan_type == "wgan":
            loss = -torch.mean(x) if target_is_real else torch.mean(x)
        elif self.gan_type == "wgan_softplus":
            loss = torch.mean(F.softplus(-x) if target_is_real else F.softplus(x))
        else:  # hinge
            if is_disc:
                loss = torch.mean(F.relu(1 + (-x if target_is_real else x)))
            else:
                loss = -torch.mean(x)
        # a D loss never carries loss_weight; a hinge D loss is returned as is
        # (reference gan_loss.py:94-100)
        if is_disc:
            return loss
        return loss * self.loss_weight


@LOSS_REGISTRY.register()
class MultiScaleGANLoss(GANLoss):
    """``GANLoss`` over a list of predictions (one per scale; of a nested
    list, its last entry), averaged over the scales."""

    def __call__(self, x, target_is_real, is_disc=False):
        if isinstance(x, (list, tuple)):
            total = 0.0
            for pred in x:
                if isinstance(pred, (list, tuple)):
                    pred = pred[-1]
                total = total + super().__call__(pred, target_is_real, is_disc) / len(x)
            return total
        return super().__call__(x, target_is_real, is_disc)


@LOSS_REGISTRY.register()
class GANFeatLoss:
    """Feature matching over a multiscale D's intermediate features
    (upstream BasicSR GANFeatLoss): ``pred_fake`` and ``pred_real`` are lists
    (one per D) of lists of per-layer features whose last entry is the
    logits; the real features carry no gradient."""

    def __init__(self, criterion="l1", loss_weight=1.0, reduction="mean"):
        if criterion not in ("l1", "l2", "charbonnier"):
            raise ValueError(f"Unsupported loss mode: {criterion}")
        self.criterion = criterion
        self.loss_weight = loss_weight

    def _elem(self, a, b):
        if self.criterion == "l1":
            return torch.mean(torch.abs(a - b))
        if self.criterion == "l2":
            return torch.mean((a - b) ** 2)
        return torch.mean(torch.sqrt((a - b) ** 2 + 1e-12))

    def __call__(self, pred_fake, pred_real):
        num_d = len(pred_fake)
        loss = 0.0
        for i in range(num_d):
            for j in range(len(pred_fake[i]) - 1):       # intermediate features only
                loss = loss + self._elem(pred_fake[i][j], pred_real[i][j].detach()) / num_d
        return loss * self.loss_weight
