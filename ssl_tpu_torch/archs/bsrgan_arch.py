"""BSRGAN / BebyGAN RRDB generators (reference: archs/bsrgan_arch.py:73,
archs/rrdbbebygan_arch.py:54).

Counterpart of ``ssl_tpu/archs/bsrgan_arch.py``: an RRDB trunk with two
nearest x2 upsamplings (one at scale 2) and no pixel-unshuffle.  Module
names follow the reference state dict (``conv_first``, ``body.{i}``,
``trunk_conv``, ``upconv1``, ``upconv2``, ``HRconv``, ``conv_last``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ssl_tpu_torch.archs.arch_util import make_layer
from ssl_tpu_torch.archs.rrdbnet_arch import RRDB, init_rrdb_net
from ssl_tpu_torch.utils.registry import ARCH_REGISTRY


class _RRDBTrunkNet(nn.Module):
    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_block=23, num_grow_ch=32,
                 upscale=4):
        super().__init__()
        self.upscale = upscale
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = make_layer(RRDB, num_block, num_feat=num_feat, num_grow_ch=num_grow_ch)
        self.trunk_conv = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.upconv1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        if upscale == 4:
            self.upconv2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.HRconv = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_rrdb_net(self, generator)

    def forward(self, x):
        lrelu = lambda v: F.leaky_relu(v, 0.2)  # noqa: E731
        fea = self.conv_first(x)
        fea = fea + self.trunk_conv(self.body(fea))
        fea = lrelu(self.upconv1(F.interpolate(fea, scale_factor=2, mode="nearest")))
        if self.upscale == 4:
            fea = lrelu(self.upconv2(F.interpolate(fea, scale_factor=2, mode="nearest")))
        return self.conv_last(lrelu(self.HRconv(fea)))


@ARCH_REGISTRY.register()
class BSRGANRRDBNet(_RRDBTrunkNet):
    """KAIR/BSRGAN RRDB net (reference bsrgan_arch.py:73-103), sf 2 or 4."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64, nb: int = 23,
                 gc: int = 32, sf: int = 4):
        super().__init__(in_nc, out_nc, nf, nb, gc, sf)


@ARCH_REGISTRY.register()
class RRDBBebyGANNet(_RRDBTrunkNet):
    """BebyGAN generator (reference rrdbbebygan_arch.py:54-80), fixed x4."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64, nb: int = 23,
                 gc: int = 32):
        super().__init__(in_nc, out_nc, nf, nb, gc, 4)
