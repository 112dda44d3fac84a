"""GAN losses: vanilla / lsgan / wgan / wgan_softplus / hinge.

Counterpart of ``ssl_tpu/losses/gan_loss.py::GANLoss`` (reference
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
