"""SRVGGNetCompact, the compact VGG-style RealESRGAN net (reference:
archs/srvgg_arch.py:7-70).

Counterpart of ``ssl_tpu/archs/srvgg_arch.py``.  Module names follow the
reference state dict: ``body.{k}`` alternates conv and activation (a
per-channel ``nn.PReLU``, the JAX package's ``ChannelPReLU``), the last conv
feeds a pixel shuffle, and the nearest-upsampled input is added."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ssl_tpu_torch.archs.arch_util import normal_init_
from ssl_tpu_torch.utils.registry import ARCH_REGISTRY


def _act(act_type: str, num_feat: int) -> nn.Module:
    if act_type == "relu":
        return nn.ReLU()
    if act_type == "prelu":
        return nn.PReLU(num_parameters=num_feat, init=0.25)
    if act_type == "leakyrelu":
        return nn.LeakyReLU(0.1)
    raise ValueError(act_type)


@ARCH_REGISTRY.register()
class SRVGGNetCompact(nn.Module):

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_conv: int = 16, upscale: int = 4, act_type: str = "prelu"):
        super().__init__()
        self.upscale = upscale
        body = [nn.Conv2d(num_in_ch, num_feat, 3, 1, 1), _act(act_type, num_feat)]
        for _ in range(num_conv):
            body += [nn.Conv2d(num_feat, num_feat, 3, 1, 1), _act(act_type, num_feat)]
        body.append(nn.Conv2d(num_feat, num_out_ch * upscale * upscale, 3, 1, 1))
        self.body = nn.ModuleList(body)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Convs from N(0, 1 / fan_in), zero biases, PReLU slopes 0.25."""
        normal_init_(self, generator)
        for m in self.modules():
            if isinstance(m, nn.PReLU):
                m.weight.fill_(0.25)

    def forward(self, x):
        out = x
        for layer in self.body:
            out = layer(out)
        out = F.pixel_shuffle(out, self.upscale)
        return out + F.interpolate(x, scale_factor=self.upscale, mode="nearest")
