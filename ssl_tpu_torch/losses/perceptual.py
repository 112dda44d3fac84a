"""Perceptual (VGG19 feature) loss with optional Gram-style term.

Counterpart of ``ssl_tpu/losses/perceptual.py::PerceptualLoss`` (reference
basicsr/losses/basic_loss.py:161-266).  The VGG19 tower is frozen.  Its
weights come from a torchvision-format ``vgg19`` state dict when a file is
given (``vgg_path`` or the ``VGG19_PTH`` environment variable), else from a
``torch.Generator`` seeded with ``vgg_seed``."""

from __future__ import annotations

import os

import torch
from torch import nn

from ssl_tpu_torch.archs.vgg_arch import VGGFeatureExtractor, load_torchvision_vgg19
from ssl_tpu_torch.utils.registry import LOSS_REGISTRY


def _gram(x):
    b, c, h, w = x.shape
    f = x.reshape(b, c, h * w)
    return f @ f.transpose(1, 2) / (c * h * w)


@LOSS_REGISTRY.register()
class PerceptualLoss(nn.Module):
    def __init__(self, layer_weights, vgg_type="vgg19", use_input_norm=True,
                 range_norm=False, perceptual_weight=1.0, style_weight=0.0,
                 criterion="l1", vgg_path=None, vgg_seed: int = 0):
        super().__init__()
        if not vgg_type.startswith("vgg19"):
            raise NotImplementedError("only vgg19 is wired up (reference default)")
        if criterion not in ("l1", "l2", "mse", "fro"):
            raise NotImplementedError(f"{criterion} criterion has not been supported.")
        self.layer_weights = dict(layer_weights)
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.criterion = criterion
        self.vgg = VGGFeatureExtractor(layer_name_list=tuple(self.layer_weights),
                                       use_input_norm=use_input_norm, range_norm=range_norm)
        vgg_path = vgg_path or os.environ.get("VGG19_PTH")
        if vgg_path and os.path.exists(vgg_path):
            load_torchvision_vgg19(self.vgg, vgg_path)
        else:
            self.vgg.reset_parameters(torch.Generator().manual_seed(vgg_seed))
        self.vgg.requires_grad_(False)
        self.vgg.eval()

    def train(self, mode: bool = True):
        # the tower stays in eval mode: it is a fixed feature map
        super().train(mode)
        self.vgg.eval()
        return self

    def _dist(self, a, b):
        if self.criterion == "l1":
            return torch.mean(torch.abs(a - b))
        if self.criterion in ("l2", "mse"):
            return torch.mean((a - b) ** 2)
        return torch.linalg.vector_norm(a - b)

    def forward(self, x, gt):
        """x, gt: NCHW in [0, 1].  Returns (percep_loss, style_loss)."""
        fx = self.vgg(x)
        with torch.no_grad():
            fgt = self.vgg(gt.detach())
        percep = x.new_zeros(())
        style = x.new_zeros(())
        for name, wgt in self.layer_weights.items():
            percep = percep + self._dist(fx[name], fgt[name]) * wgt
            if self.style_weight > 0:
                style = style + self._dist(_gram(fx[name]), _gram(fgt[name])) * wgt
        return percep * self.perceptual_weight, style * self.style_weight
