"""MSRResNet generator (reference: archs/srresnet_arch.py:8-65).

Counterpart of ``ssl_tpu/archs/srresnet_arch.py``: 16 no-BN residual blocks,
pixel-shuffle upsampling and a bilinear (``align_corners=False``) base of
the input added to the output.  Module names follow the reference state
dict (``conv_first``, ``body.{i}.conv1/conv2``, ``upconv1``, ``upconv2``,
``conv_hr``, ``conv_last``), so the reference's checkpoints load."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ssl_tpu_torch.archs.arch_util import make_layer, normal_init_
from ssl_tpu_torch.utils.registry import ARCH_REGISTRY


class ResidualBlockNoBN(nn.Module):
    """conv-relu-conv residual block without BN (reference arch_util.py:44-75)."""

    def __init__(self, num_feat: int = 64, res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x))) * self.res_scale


@ARCH_REGISTRY.register()
class MSRResNet(nn.Module):

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_block: int = 16, upscale: int = 4):
        super().__init__()
        if upscale not in (2, 3, 4):
            raise ValueError(f"MSRResNet upscale must be 2, 3 or 4, got {upscale}")
        self.upscale = upscale
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = make_layer(ResidualBlockNoBN, num_block, num_feat=num_feat)
        if upscale == 4:
            self.upconv1 = nn.Conv2d(num_feat, num_feat * 4, 3, 1, 1)
            self.upconv2 = nn.Conv2d(num_feat, num_feat * 4, 3, 1, 1)
        else:
            self.upconv1 = nn.Conv2d(num_feat, num_feat * upscale ** 2, 3, 1, 1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's ``default_init_weights(..., 0.1)``: kaiming normal
        scaled by 0.1 on every conv, zero biases."""
        normal_init_(self, generator, gain=2.0, scale=0.1)

    def forward(self, x):
        def lrelu(v):
            return F.leaky_relu(v, 0.1)

        feat = lrelu(self.conv_first(x))
        out = self.body(feat)
        if self.upscale == 4:
            out = lrelu(F.pixel_shuffle(self.upconv1(out), 2))
            out = lrelu(F.pixel_shuffle(self.upconv2(out), 2))
        else:
            out = lrelu(F.pixel_shuffle(self.upconv1(out), self.upscale))
        out = self.conv_last(lrelu(self.conv_hr(out)))
        h, w = x.shape[-2:]
        base = F.interpolate(x, size=(h * self.upscale, w * self.upscale), mode="bilinear",
                             align_corners=False)
        return out + base
