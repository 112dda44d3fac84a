"""RankSRGAN: the SRResNet generator, the 296-patch discriminator and the
frozen Ranker (reference: archs/ranksrgan_arch.py:54, :108, :168).

Counterpart of ``ssl_tpu/archs/ranksrgan_arch.py``.  Module names follow the
reference state dicts.  Both VGG stacks' batch norms follow flax's
``BatchNorm(momentum=0.9)`` (the port's ``BatchNorm2d``); their heads flatten
NCHW, as the reference does, so ``params_from_jax`` reorders the rows of the
flax head (which flattens NHWC).

``Discriminator_VGG_296``'s first linear layer takes the features of the
crop it judges: ``input_size`` (the train set's ``gt_size``, which the
recipe passes) halved five times, times 8 nf channels."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ssl_tpu_torch.archs.arch_util import normal_init_
from ssl_tpu_torch.archs.discriminator_arch import BatchNorm2d
from ssl_tpu_torch.utils.registry import ARCH_REGISTRY


class _ResBlockReLU(nn.Module):
    def __init__(self, nf: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.conv2 = nn.Conv2d(nf, nf, 3, 1, 1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


@ARCH_REGISTRY.register()
class RankSRGANSRResNet(nn.Module):
    """SRResNet with the LR features added back before the upsampler."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64, nb: int = 16,
                 upscale: int = 4):
        super().__init__()
        self.upscale = upscale
        self.conv_first = nn.Conv2d(in_nc, nf, 3, 1, 1)
        self.recon_trunk = nn.Sequential(*[_ResBlockReLU(nf) for _ in range(nb)])
        self.LRconv = nn.Conv2d(nf, nf, 3, 1, 1)
        if upscale == 4:
            self.upconv1 = nn.Conv2d(nf, nf * 4, 3, 1, 1)
            self.upconv2 = nn.Conv2d(nf, nf * 4, 3, 1, 1)
        else:
            self.upconv1 = nn.Conv2d(nf, nf * upscale * upscale, 3, 1, 1)
        self.HRconv = nn.Conv2d(nf, nf, 3, 1, 1)
        self.conv_last = nn.Conv2d(nf, out_nc, 3, 1, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_init_(self, generator)
        normal_init_(self.recon_trunk, generator, gain=2.0, scale=0.1)

    def forward(self, x):
        fea = self.conv_first(x)
        out = self.LRconv(self.recon_trunk(fea))
        if self.upscale == 4:
            out = F.relu(F.pixel_shuffle(self.upconv1(out + fea), 2))
            out = F.relu(F.pixel_shuffle(self.upconv2(out), 2))
        else:
            out = F.relu(F.pixel_shuffle(self.upconv1(out + fea), self.upscale))
        return self.conv_last(F.relu(self.HRconv(out)))


class _VGGStack(nn.Module):
    """Five (3x3 conv, 4x4 stride-2 conv) stages with batch norms after all
    but the first conv: conv0_0, conv0_1/bn0_1, conv{k}_0/bn{k}_0,
    conv{k}_1/bn{k}_1 for k = 1..4."""

    def __init__(self, in_nc: int, nf: int, bias: bool):
        super().__init__()
        self.conv0_0 = nn.Conv2d(in_nc, nf, 3, 1, 1)
        self.conv0_1 = nn.Conv2d(nf, nf, 4, 2, 1, bias=bias)
        self.bn0_1 = BatchNorm2d(nf)
        cin = nf
        for k in range(1, 5):
            f = nf * min(2 ** k, 8)
            setattr(self, f"conv{k}_0", nn.Conv2d(cin, f, 3, 1, 1, bias=bias))
            setattr(self, f"bn{k}_0", BatchNorm2d(f))
            setattr(self, f"conv{k}_1", nn.Conv2d(f, f, 4, 2, 1, bias=bias))
            setattr(self, f"bn{k}_1", BatchNorm2d(f))
            cin = f
        self.out_ch = cin

    def features(self, x):
        lrelu = lambda v: F.leaky_relu(v, 0.2)  # noqa: E731
        feat = lrelu(self.conv0_0(x))
        feat = lrelu(self.bn0_1(self.conv0_1(feat)))
        for k in range(1, 5):
            for j in (0, 1):
                feat = lrelu(getattr(self, f"bn{k}_{j}")(getattr(self, f"conv{k}_{j}")(feat)))
        return feat

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_init_(self, generator)


@ARCH_REGISTRY.register()
class Discriminator_VGG_296(_VGGStack):
    """Patch discriminator (reference :108-165): its convs after the first
    have no bias; train mode normalizes by batch statistics."""

    def __init__(self, in_nc: int = 3, nf: int = 64, input_size: int = 128):
        super().__init__(in_nc, nf, bias=False)
        if input_size % 32:
            raise ValueError(f"input_size must be a multiple of 32, got {input_size}")
        self.input_size = input_size
        side = input_size // 32
        self.linear1 = nn.Linear(self.out_ch * side * side, 100)
        self.linear2 = nn.Linear(100, 1)

    def forward(self, x):
        if x.shape[-2:] != (self.input_size, self.input_size):
            raise ValueError(f"input must be {self.input_size}x{self.input_size}, "
                             f"got {tuple(x.shape)}")
        feat = F.leaky_relu(self.linear1(self.features(x).flatten(1)), 0.2)
        return self.linear2(feat)


@ARCH_REGISTRY.register()
class Ranker_VGG12_296(_VGGStack):
    """The frozen perceptual Ranker (reference :168-227): every conv with a
    bias, a global average pool, then Linear(8 nf, 100) - lrelu -
    Linear(100, 1).  The recipe runs it in eval mode (running statistics)."""

    def __init__(self, in_nc: int = 3, nf: int = 64):
        super().__init__(in_nc, nf, bias=True)
        self.linear1 = nn.Linear(self.out_ch, 100)
        self.linear2 = nn.Linear(100, 1)

    def forward(self, x):
        feat = self.features(x).mean(dim=(2, 3))
        return self.linear2(F.leaky_relu(self.linear1(feat), 0.2))
