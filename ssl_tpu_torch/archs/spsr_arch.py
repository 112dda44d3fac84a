"""SPSR — Structure-Preserving Super-Resolution, dual-branch generator
(reference: archs/spsr_arch.py:261-438).

Counterpart of ``ssl_tpu/archs/spsr_arch.py``.  An RRDB trunk whose
features after blocks 5, 10, 15 and 20 feed a gradient branch; the branch's
features and the trunk's are fused into the SR image.  ``forward`` returns
``(x_out_branch, x_out, x_grad)``: the branch's gradient map, the SR image
and the input's gradient map.  Every RRDB grows by 32 channels whatever
``gc`` says (the reference hard-codes it); the branch and fusion RRDBs are
``2 nf`` wide.  The fusion modules' names start with ``f_``, which
``Branch_pretrain`` keys on."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ssl_tpu_torch.archs.rrdbnet_arch import RRDB, init_rrdb_net
from ssl_tpu_torch.utils.registry import ARCH_REGISTRY

TAPS = (5, 10, 15, 20)


def image_gradient(x: torch.Tensor) -> torch.Tensor:
    """Per-channel central-difference gradient magnitude with zero padding,
    sqrt(gv^2 + gh^2 + 1e-6) (reference Get_gradient_nopadding :261-287).
    NCHW."""
    xp = F.pad(x, (1, 1, 1, 1))
    gv = xp[:, :, 2:, 1:-1] - xp[:, :, :-2, 1:-1]
    gh = xp[:, :, 1:-1, 2:] - xp[:, :, 1:-1, :-2]
    return torch.sqrt(gv ** 2 + gh ** 2 + 1e-6)


def _conv(cin, cout, k=3):
    return nn.Conv2d(cin, cout, k, 1, (k - 1) // 2)


def _up(x, conv):
    return F.leaky_relu(conv(F.interpolate(x, scale_factor=2, mode="nearest")), 0.2)


@ARCH_REGISTRY.register()
class SPSRNet(nn.Module):

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64, nb: int = 23,
                 gc: int = 32, upscale: int = 4):
        super().__init__()
        if nb < TAPS[-1]:
            raise ValueError(f"SPSRNet taps the trunk after blocks {TAPS}: nb must be at "
                             f"least {TAPS[-1]}, got {nb}")
        n_up = int(math.log2(upscale))
        self.fea_conv = _conv(in_nc, nf)
        self.rb = nn.ModuleList(RRDB(nf, 32) for _ in range(nb))
        self.LR_conv = _conv(nf, nf)
        self.up = nn.ModuleList(_conv(nf, nf) for _ in range(n_up))
        self.HR_conv0 = _conv(nf, nf)
        self.HR_conv1 = _conv(nf, nf)
        self.b_fea_conv = _conv(in_nc, nf)
        self.b_block = nn.ModuleList(RRDB(nf * 2, 32) for _ in TAPS)
        self.b_concat = nn.ModuleList(_conv(nf * 2, nf) for _ in TAPS)
        self.b_LR_conv = _conv(nf, nf)
        self.b_up = nn.ModuleList(_conv(nf, nf) for _ in range(n_up))
        self.b_HR_conv0 = _conv(nf, nf)
        self.b_HR_conv1 = _conv(nf, nf)
        self.conv_w = _conv(nf, out_nc, 1)
        self.f_block = RRDB(nf * 2, 32)
        self.f_concat = _conv(nf * 2, nf)
        self.f_HR_conv0 = _conv(nf, nf)
        self.f_HR_conv1 = _conv(nf, out_nc)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_rrdb_net(self, generator)

    def forward(self, x):
        lrelu = lambda v: F.leaky_relu(v, 0.2)  # noqa: E731
        x_grad = image_gradient(x)

        feat = self.fea_conv(x)
        taps, h = [], feat
        for i, block in enumerate(self.rb):
            h = block(h)
            if i + 1 in TAPS:
                taps.append(h)
        h = feat + self.LR_conv(h)
        for conv in self.up:
            h = _up(h, conv)
        h = self.HR_conv1(lrelu(self.HR_conv0(h)))

        b = self.b_fea_conv(x_grad)
        cat = b
        for tap, block, concat in zip(taps, self.b_block, self.b_concat):
            cat = concat(block(torch.cat([cat, tap], 1)))
        cat = self.b_LR_conv(cat) + b
        for conv in self.b_up:
            cat = _up(cat, conv)
        x_branch = self.b_HR_conv1(lrelu(self.b_HR_conv0(cat)))
        x_out_branch = self.conv_w(x_branch)

        f = self.f_concat(self.f_block(torch.cat([x_branch, h], 1)))
        x_out = self.f_HR_conv1(lrelu(self.f_HR_conv0(f)))
        return x_out_branch, x_out, x_grad
