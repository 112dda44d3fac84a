"""Discriminators (reference: archs/discriminator_arch.py).

Counterpart of ``ssl_tpu/archs/discriminator_arch.py::VGGStyleDiscriminator``,
the D of the shipped ESRGAN-SSL config.  ``UNetDiscriminatorSN`` waits for
the RealESRGAN slice (ROADMAP.md).

Module names follow the reference state dict (conv0_0, conv0_1/bn0_1, ...,
linear1, linear2), whose head flattens NCHW.  The batch norms follow flax's
``BatchNorm(momentum=0.9)``: train mode normalizes by the biased batch
variance, and the running variance is updated with that same biased
variance (torch's own BatchNorm2d would use the unbiased one)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ssl_tpu_torch.archs.arch_util import normal_init_
from ssl_tpu_torch.utils.registry import ARCH_REGISTRY


class BatchNorm2d(nn.BatchNorm2d):
    """Batch norm with flax's statistics rule (see the module docstring).
    Running stats are updated in place in train mode."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        mean = torch.mean(x, dim=(0, 2, 3))
        var = torch.clamp(torch.mean(x * x, dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(mean * self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var * self.momentum)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[None, :, None, None]) * mul[None, :, None, None] \
            + self.bias[None, :, None, None]


@ARCH_REGISTRY.register()
class VGGStyleDiscriminator(nn.Module):
    """VGG-style D with BN and stride-2 halving (reference
    discriminator_arch.py:113-191): 128 ends at 4x4, 192 at 3x3 after one
    more stage."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64, input_size: int = 128):
        super().__init__()
        if input_size not in (128, 192):
            raise ValueError(f"input size must be 128 or 192, got {input_size}")
        self.input_size = input_size
        nf = num_feat
        self.conv0_0 = nn.Conv2d(num_in_ch, nf, 3, 1, 1, bias=True)
        self.conv0_1 = nn.Conv2d(nf, nf, 4, 2, 1, bias=False)
        self.bn0_1 = BatchNorm2d(nf)
        chans = [nf, nf * 2, nf * 4, nf * 8, nf * 8, nf * 8]
        n_stages = 5 if input_size == 192 else 4
        for i in range(1, n_stages + 1):
            cin, cout = chans[i - 1], chans[i]
            setattr(self, f"conv{i}_0", nn.Conv2d(cin, cout, 3, 1, 1, bias=False))
            setattr(self, f"bn{i}_0", BatchNorm2d(cout))
            setattr(self, f"conv{i}_1", nn.Conv2d(cout, cout, 4, 2, 1, bias=False))
            setattr(self, f"bn{i}_1", BatchNorm2d(cout))
        self.n_stages = n_stages
        side = input_size // 2 ** (n_stages + 1)         # 4 at 128, 3 at 192
        self.linear1 = nn.Linear(nf * 8 * side * side, 100)
        self.linear2 = nn.Linear(100, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_init_(self, generator)

    def forward(self, x):
        if x.shape[-1] != self.input_size or x.shape[-2] != self.input_size:
            raise ValueError(f"input must be {self.input_size}x{self.input_size}, "
                             f"got {tuple(x.shape)}")
        lrelu = lambda v: F.leaky_relu(v, 0.2)  # noqa: E731
        feat = lrelu(self.conv0_0(x))
        feat = lrelu(self.bn0_1(self.conv0_1(feat)))
        for i in range(1, self.n_stages + 1):
            feat = lrelu(getattr(self, f"bn{i}_0")(getattr(self, f"conv{i}_0")(feat)))
            feat = lrelu(getattr(self, f"bn{i}_1")(getattr(self, f"conv{i}_1")(feat)))
        feat = lrelu(self.linear1(feat.flatten(1)))
        return self.linear2(feat)
