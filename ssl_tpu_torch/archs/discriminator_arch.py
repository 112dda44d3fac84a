"""Discriminators (reference: archs/discriminator_arch.py).

Counterpart of ``ssl_tpu/archs/discriminator_arch.py``:
``VGGStyleDiscriminator``, the D of the shipped ESRGAN-SSL config, and
``UNetDiscriminatorSN``, the D of RealESRGAN-SSL.

VGGStyleDiscriminator's module names follow the reference state dict
(conv0_0, conv0_1/bn0_1, ..., linear1, linear2), whose head flattens NCHW.
Its batch norms follow flax's ``BatchNorm(momentum=0.9)``: train mode
normalizes by the biased batch variance, and the running variance is updated
with that same biased variance (torch's own BatchNorm2d would use the
unbiased one).

UNetDiscriminatorSN's spectral norm follows flax's ``nn.SpectralNorm``
(flax 0.12.3 ``_spectral_normalize``), not ``torch.nn.utils.spectral_norm``:
see ``SNConv2d``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ssl_tpu_torch.archs.arch_util import check_compute_dtype, normal_init_
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


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


class SNConv2d(nn.Conv2d):
    """Spectrally normalized conv with torch padding, (k - 1) // 2 on both
    sides (``ssl_tpu``'s ``_SNConv``), and flax's power-iteration rule:

    * the weight as flax sees it, HWIO reshaped to (kh kw in, out); ``u``
      (1, out) and ``sigma`` () are buffers;
    * one power-iteration step on every call, in eval too:
      v = l2n(u W^T), u' = l2n(v W) with l2n(x) = x / sqrt(|x|^2 + eps);
      u' and v carry no gradient;
    * sigma = v W u'^T (the gradient reaches W through it), and W / sigma
      where sigma != 0;
    * in train mode u' and sigma are stored (flax's ``update_stats``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 bias: bool = False, eps: float = 1e-12):
        super().__init__(in_ch, out_ch, kernel, stride, (kernel - 1) // 2, bias=bias)
        self.eps = eps
        self.register_buffer("u", torch.zeros(1, out_ch))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self) -> torch.Tensor:
        out_ch = self.weight.shape[0]
        mat = self.weight.permute(2, 3, 1, 0).reshape(-1, out_ch)
        with torch.no_grad():
            v = _l2_normalize(self.u @ mat.T, self.eps)
            u = _l2_normalize(v @ mat, self.eps)
        sigma = (v @ mat @ u.T)[0, 0]
        mat = mat / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return mat.reshape(self.weight.shape[2], self.weight.shape[3], self.weight.shape[1],
                           out_ch).permute(3, 2, 0, 1)

    def forward(self, x):
        return F.conv2d(x, self.normalized_weight(), self.bias, self.stride, self.padding)


@ARCH_REGISTRY.register()
class UNetDiscriminatorSN(nn.Module):
    """U-Net discriminator with spectral norm and skip connections
    (reference discriminator_arch.py:326-385); returns a per-pixel logit
    map (b, 1, h, w).  The x2 upsamplings are ``F.interpolate`` bilinear
    with ``align_corners=False``, which is what ``jax.image.resize``'s
    bilinear computes for a factor of 2.  ``compute_dtype`` (the JAX
    package's bf16 knob) raises: ROADMAP.md queues the bf16 knobs."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64, skip_connection: bool = True,
                 compute_dtype=None):
        super().__init__()
        check_compute_dtype(compute_dtype)
        self.skip_connection = skip_connection
        nf = num_feat
        self.conv0 = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        self.conv1 = SNConv2d(nf, nf * 2, 4, 2)
        self.conv2 = SNConv2d(nf * 2, nf * 4, 4, 2)
        self.conv3 = SNConv2d(nf * 4, nf * 8, 4, 2)
        self.conv4 = SNConv2d(nf * 8, nf * 4, 3)
        self.conv5 = SNConv2d(nf * 4, nf * 2, 3)
        self.conv6 = SNConv2d(nf * 2, nf, 3)
        self.conv7 = SNConv2d(nf, nf, 3)
        self.conv8 = SNConv2d(nf, nf, 3)
        self.conv9 = nn.Conv2d(nf, 1, 3, 1, 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Weights from N(0, 1 / fan_in), zero biases, and each ``u`` from
        N(0, 1) (flax draws it with ``jax.random.normal``)."""
        normal_init_(self, generator)
        for m in self.modules():
            if isinstance(m, SNConv2d):
                m.u.copy_(torch.randn(m.u.shape, generator=generator))
                m.sigma.fill_(1.0)

    def forward(self, x):
        def lrelu(v):
            return F.leaky_relu(v, 0.2)

        def up2(v):
            return F.interpolate(v, size=(2 * v.shape[-2], 2 * v.shape[-1]), mode="bilinear",
                                 align_corners=False)

        x0 = lrelu(self.conv0(x))
        x1 = lrelu(self.conv1(x0))
        x2 = lrelu(self.conv2(x1))
        x3 = lrelu(self.conv3(x2))
        x4 = lrelu(self.conv4(up2(x3)))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = lrelu(self.conv5(up2(x4)))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = lrelu(self.conv6(up2(x5)))
        if self.skip_connection:
            x6 = x6 + x0
        out = lrelu(self.conv7(x6))
        out = lrelu(self.conv8(out))
        return self.conv9(out)
