"""The KAIR ``net_type`` surface: the generator and discriminators that
``utils/kair_options.py`` maps to and no other recipe builds.

Counterpart of ``ssl_tpu/archs/kair_extra_arch.py`` (reference:
train_BSGRAN/models/network_discriminator.py Discriminator_PatchGAN :22-87,
Discriminator_VGG_96 :144-176, Discriminator_VGG_128 :182-216,
Discriminator_VGG_128_SN :263-311; network_msrresnet.py MSRResNet0 :38-77).

* The spectral norms follow flax's rule (``discriminator_arch.SNConv2d``,
  ``SNLinear``), as ``UNetDiscriminatorSN``'s do: one power-iteration step
  per call, the vector and sigma stored in train mode.
* The batch norms follow flax's statistics (``discriminator_arch.BatchNorm2d``),
  with torch's momentum convention: flax's ``momentum=0.1`` of the VGG
  discriminators keeps 0.1 of the running value (torch momentum 0.9), the
  PatchGAN's ``momentum=0.9`` keeps 0.9 (torch 0.1).
* The heads flatten NCHW, as the JAX modules do before their ``Dense``.
* Module names follow the flax trees (``convs.{k}`` for ``Conv_{k}``,
  ``bns.{k}`` for ``BatchNorm_{k}``, ``child{n}``, ``conv{i}``, ...), so
  ``utils/weight_port.py`` carries them across by position."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ssl_tpu_torch.archs.arch_util import normal_init_
from ssl_tpu_torch.archs.discriminator_arch import (BatchNorm2d, SNConv2d, SNLinear,
                                                    init_sn_discriminator)
from ssl_tpu_torch.utils.registry import ARCH_REGISTRY


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


@ARCH_REGISTRY.register()
class KAIRDiscriminatorPatchGAN(nn.Module):
    """70x70 PatchGAN: k4 convs padded by 2, channels doubling up to 512,
    a spectral norm on every conv for ``norm_type`` with "spectral", and a
    batch norm ("batch") or an instance norm ("instance", no affine)
    between them."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 norm_type: str = "spectral"):
        super().__init__()
        self.n_layers = n_layers
        self.norm_type = norm_type
        spectral = "spectral" in norm_type
        chans, nf = [ndf], ndf
        for _ in range(1, n_layers):
            nf = min(nf * 2, 512)
            chans.append(nf)
        chans.append(min(nf * 2, 512))
        chans.append(1)
        strides = [2] * n_layers + [1, 1]
        cin = input_nc
        for n, (cout, s) in enumerate(zip(chans, strides)):
            conv = (SNConv2d(cin, cout, 4, s, bias=True, padding=2) if spectral else
                    nn.Conv2d(cin, cout, 4, s, 2))
            setattr(self, f"child{n}", conv)
            cin = cout
        self.bns = nn.ModuleList(BatchNorm2d(c, eps=1e-5, momentum=0.1)
                                 for c in chans[1:n_layers + 1]) if "batch" in norm_type else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_sn_discriminator(self, generator)

    def _norm(self, x, i):
        if self.bns is not None:
            return self.bns[i](x)
        if "instance" in self.norm_type:
            # flax GroupNorm(group_size=1): per-sample, per-channel, biased variance
            mean = x.mean(dim=(2, 3), keepdim=True)
            var = torch.clamp((x * x).mean(dim=(2, 3), keepdim=True) - mean * mean, min=0.0)
            return (x - mean) * torch.rsqrt(var + 1e-5)
        return x

    def forward(self, x):
        h = _lrelu(self.child0(x))
        for n in range(1, self.n_layers + 1):
            h = _lrelu(self._norm(getattr(self, f"child{n}")(h), n - 1))
        return getattr(self, f"child{self.n_layers + 1}")(h)


class _KAIRVGGD(nn.Module):
    """The KAIR VGG discriminators: a bare k3 head conv (no activation), then
    (k3 s1, k4 s2) pairs with batch norm ("B" in ``ac_type``, eps 1e-4) and
    leaky ReLU 0.2, then Linear(100), leaky ReLU, Linear(1)."""
    input_size = 128

    def __init__(self, in_nc: int = 3, base_nc: int = 64, ac_type: str = "BL"):
        super().__init__()
        n_pairs = {96: 5, 128: 5, 192: 6}[self.input_size]
        mults = [1, 2, 4, 8, 8, 8][:n_pairs]
        self.use_bn = "B" in ac_type
        convs = [nn.Conv2d(in_nc, base_nc, 3, 1, 1), nn.Conv2d(base_nc, base_nc, 4, 2, 1)]
        cin = base_nc
        for m in mults[1:]:
            convs += [nn.Conv2d(cin, base_nc * m, 3, 1, 1),
                      nn.Conv2d(base_nc * m, base_nc * m, 4, 2, 1)]
            cin = base_nc * m
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(BatchNorm2d(c.out_channels, eps=1e-4, momentum=0.9)
                                 for c in convs[1:]) if self.use_bn else None
        side = self.input_size // 2 ** n_pairs
        self.linear0 = nn.Linear(cin * side * side, 100)
        self.linear1 = nn.Linear(100, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_sn_discriminator(self, generator)

    def forward(self, x):
        h = self.convs[0](x)
        for k, conv in enumerate(self.convs[1:]):
            h = conv(h)
            if self.use_bn:
                h = self.bns[k](h)
            h = _lrelu(h)
        return self.linear1(_lrelu(self.linear0(h.flatten(1))))


@ARCH_REGISTRY.register()
class KAIRDiscriminatorVGG96(_KAIRVGGD):
    input_size = 96


@ARCH_REGISTRY.register()
class KAIRDiscriminatorVGG128(_KAIRVGGD):
    input_size = 128


@ARCH_REGISTRY.register()
class KAIRDiscriminatorVGG192(_KAIRVGGD):
    input_size = 192


@ARCH_REGISTRY.register()
class KAIRDiscriminatorVGG128SN(nn.Module):
    """Spectral-norm VGG-128 D: spectral norms on all ten convs and both
    linear layers, leaky ReLU 0.2 after each but the last, no batch norm."""
    CHANS = ((64, 3, 1), (64, 4, 2), (128, 3, 1), (128, 4, 2), (256, 3, 1), (256, 4, 2),
             (512, 3, 1), (512, 4, 2), (512, 3, 1), (512, 4, 2))

    def __init__(self, in_nc: int = 3):
        super().__init__()
        cin = in_nc
        for i, (f, k, s) in enumerate(self.CHANS):
            setattr(self, f"conv{i}", SNConv2d(cin, f, k, s, bias=True))
            cin = f
        self.linear0 = SNLinear(512 * 4 * 4, 100)
        self.linear1 = SNLinear(100, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_sn_discriminator(self, generator)

    def forward(self, x):
        h = x
        for i in range(len(self.CHANS)):
            h = _lrelu(getattr(self, f"conv{i}")(h))
        return self.linear1(_lrelu(self.linear0(h.flatten(1))))


class _ResBlock0(nn.Module):
    def __init__(self, nc: int):
        super().__init__()
        self.conv0 = nn.Conv2d(nc, nc, 3, 1, 1)
        self.conv1 = nn.Conv2d(nc, nc, 3, 1, 1)

    def forward(self, x):
        return x + self.conv1(F.relu(self.conv0(x)))


@ARCH_REGISTRY.register()
class KAIRMSRResNet0(nn.Module):
    """MSRResNet v0, the old flat ESRGAN layout: head conv, nb plain ReLU
    residual blocks under a global shortcut, per x2 (or x3) stage a nearest
    upsampling, a conv and ReLU, then an HR conv with ReLU and a bias-free
    tail conv.  No bilinear base."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nc: int = 64, nb: int = 16,
                 upscale: int = 4):
        super().__init__()
        self.n_up = {2: 1, 3: 1, 4: 2}[upscale]
        self.step = 3 if upscale == 3 else 2
        self.head = nn.Conv2d(in_nc, nc, 3, 1, 1)
        self.blocks = nn.Sequential(*[_ResBlock0(nc) for _ in range(nb)])
        self.body_out = nn.Conv2d(nc, nc, 3, 1, 1)
        self.ups = nn.ModuleList(nn.Conv2d(nc, nc, 3, 1, 1) for _ in range(self.n_up))
        self.hr = nn.Conv2d(nc, nc, 3, 1, 1)
        self.tail = nn.Conv2d(nc, out_nc, 3, 1, 1, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_init_(self, generator)

    def forward(self, x):
        feat = self.head(x)
        h = feat + self.body_out(self.blocks(feat))
        for up in self.ups:
            h = F.relu(up(F.interpolate(h, scale_factor=self.step, mode="nearest")))
        return self.tail(F.relu(self.hr(h)))
