"""Discriminators (reference: archs/discriminator_arch.py).

Counterpart of ``ssl_tpu/archs/discriminator_arch.py``:
``VGGStyleDiscriminator``, the D of the shipped ESRGAN-SSL config,
``UNetDiscriminatorSN``, the D of RealESRGAN-SSL, and the registry's other
discriminators, which no shipped option file names: ``UNetDiscriminatorSNv1``,
``MOD``, ``Discriminator_VGG_192``, ``DiscriminatorSN_VGG_192`` and
``NLayerDiscriminator``.

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

from ssl_tpu_torch.archs.arch_util import Conv2d, compute_dtype_of, normal_init_
from ssl_tpu_torch.utils.registry import ARCH_REGISTRY


class BatchNorm2d(nn.BatchNorm2d):
    """Batch norm with flax's statistics rule (see the module docstring).
    Running stats are updated in place in train mode.

    Synced when ``sync`` is set (a model's ``place_state`` sets it under a
    process group): the train-mode statistics are those of the global batch,
    the per-channel sums of x and x^2 added over the data ranks in one
    all-reduce that carries their gradient, as the JAX step normalizes its
    global array.  The running stats then move alike on every rank."""

    #: (a sum over the data ranks that carries its gradient, their number)
    sync = None

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.sync is not None:
            total, ranks = self.sync
            sums = total(torch.stack([torch.sum(x, dim=(0, 2, 3)),
                                      torch.sum(x * x, dim=(0, 2, 3))]))
            sums = sums / float(x.numel() // x.shape[1] * ranks)
            mean, sq = sums[0], sums[1]
        else:
            mean, sq = torch.mean(x, dim=(0, 2, 3)), torch.mean(x * x, dim=(0, 2, 3))
        var = torch.clamp(sq - mean * mean, min=0.0)
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


def spectral_normalize(module: nn.Module, mat: torch.Tensor) -> torch.Tensor:
    """flax's power-iteration rule on the (fan_in, out) matrix ``mat`` of
    ``module``, whose buffers ``u`` (1, out) and ``sigma`` () it reads and,
    in train mode, stores:

    * one power-iteration step on every call, in eval too:
      v = l2n(u W^T), u' = l2n(v W) with l2n(x) = x / sqrt(|x|^2 + eps);
      u' and v carry no gradient;
    * sigma = v W u'^T (the gradient reaches W through it), and W / sigma
      where sigma != 0;
    * in train mode u' and sigma are stored (flax's ``update_stats``)."""
    with torch.no_grad():
        v = _l2_normalize(module.u @ mat.T, module.eps)
        u = _l2_normalize(v @ mat, module.eps)
    sigma = (v @ mat @ u.T)[0, 0]
    mat = mat / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
    if module.training:
        with torch.no_grad():
            module.u.copy_(u)
            module.sigma.copy_(sigma)
    return mat


class SNConv2d(nn.Conv2d):
    """Spectrally normalized conv with torch padding, ``padding`` on each
    side ((k - 1) // 2 unless given, as ``ssl_tpu``'s ``_SNConv``), and
    flax's power-iteration rule (``spectral_normalize``) on the weight as
    flax sees it, HWIO reshaped to (kh kw in, out)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 bias: bool = False, eps: float = 1e-12, padding: int | None = None):
        super().__init__(in_ch, out_ch, kernel, stride,
                         (kernel - 1) // 2 if padding is None else padding, bias=bias)
        self.eps = eps
        self.register_buffer("u", torch.zeros(1, out_ch))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self) -> torch.Tensor:
        out_ch = self.weight.shape[0]
        mat = spectral_normalize(self, self.weight.permute(2, 3, 1, 0).reshape(-1, out_ch))
        return mat.reshape(self.weight.shape[2], self.weight.shape[3], self.weight.shape[1],
                           out_ch).permute(3, 2, 0, 1)

    def forward(self, x):
        # the normalized float32 weight, cast to the input's dtype (flax's dtype=)
        return F.conv2d(x, self.normalized_weight().to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype), self.stride,
                        self.padding)


class SNLinear(nn.Linear):
    """A linear layer under flax's spectral norm: the matrix flax sees is
    the (in, out) kernel, the transpose of torch's weight."""

    def __init__(self, in_features: int, out_features: int, eps: float = 1e-12):
        super().__init__(in_features, out_features)
        self.eps = eps
        self.register_buffer("u", torch.zeros(1, out_features))
        self.register_buffer("sigma", torch.ones(()))

    def forward(self, x):
        return F.linear(x, spectral_normalize(self, self.weight.T).T, self.bias)


@torch.no_grad()
def init_sn_discriminator(net: nn.Module, generator: torch.Generator) -> None:
    """Weights from N(0, 1 / fan_in), zero biases, unit batch norms, and each
    spectral norm's ``u`` from N(0, 1) (flax draws it with
    ``jax.random.normal``)."""
    normal_init_(net, generator)
    for m in net.modules():
        if isinstance(m, (SNConv2d, SNLinear)):
            m.u.copy_(torch.randn(m.u.shape, generator=generator))
            m.sigma.fill_(1.0)


@ARCH_REGISTRY.register()
class UNetDiscriminatorSN(nn.Module):
    """U-Net discriminator with spectral norm and skip connections
    (reference discriminator_arch.py:326-385); returns a per-pixel logit
    map (b, 1, h, w).  The x2 upsamplings are ``F.interpolate`` bilinear
    with ``align_corners=False``, which is what ``jax.image.resize``'s
    bilinear computes for a factor of 2.  ``compute_dtype: bfloat16`` runs
    the convs, ``leaky_relu``, upsamplings and skip adds in bf16, as the JAX
    module does; the parameters and the spectral norms' ``u`` and ``sigma``
    stay float32 (the normalized weight is cast for each conv) and the logits
    come back as float32."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64, skip_connection: bool = True,
                 compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.skip_connection = skip_connection
        nf = num_feat
        self.conv0 = Conv2d(num_in_ch, nf, 3, 1, 1)
        self.conv1 = SNConv2d(nf, nf * 2, 4, 2)
        self.conv2 = SNConv2d(nf * 2, nf * 4, 4, 2)
        self.conv3 = SNConv2d(nf * 4, nf * 8, 4, 2)
        self.conv4 = SNConv2d(nf * 8, nf * 4, 3)
        self.conv5 = SNConv2d(nf * 4, nf * 2, 3)
        self.conv6 = SNConv2d(nf * 2, nf, 3)
        self.conv7 = SNConv2d(nf, nf, 3)
        self.conv8 = SNConv2d(nf, nf, 3)
        self.conv9 = Conv2d(nf, 1, 3, 1, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_sn_discriminator(self, generator)

    def forward(self, x):
        def lrelu(v):
            return F.leaky_relu(v, 0.2)

        def up2(v):
            return F.interpolate(v, size=(2 * v.shape[-2], 2 * v.shape[-1]), mode="bilinear",
                                 align_corners=False)

        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
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
        out = self.conv9(out)
        return out if self.compute_dtype is None else out.float()


@ARCH_REGISTRY.register()
class UNetDiscriminatorSNv1(nn.Module):
    """Shallow (one-level) U-Net SN discriminator (reference :388-425).  The
    upsampling goes back to conv0's size, which is not twice conv1's on an
    odd side: ``F.interpolate`` bilinear with ``align_corners=False``
    computes what ``jax.image.resize``'s bilinear does when it upsamples
    (the edge taps clamp in one and renormalise in the other, to the same
    weights)."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64, skip_connection: bool = True):
        super().__init__()
        self.skip_connection = skip_connection
        self.conv0 = Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.conv1 = SNConv2d(num_feat, num_feat * 2, 4, 2)
        self.conv2 = SNConv2d(num_feat * 2, num_feat, 3)
        self.conv3 = SNConv2d(num_feat, num_feat, 3)
        self.conv4 = Conv2d(num_feat, 1, 3, 1, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_sn_discriminator(self, generator)

    def forward(self, x):
        def lrelu(v):
            return F.leaky_relu(v, 0.2)

        x0 = lrelu(self.conv0(x))
        x1 = lrelu(self.conv1(x0))
        x1 = F.interpolate(x1, size=x0.shape[-2:], mode="bilinear", align_corners=False)
        x2 = lrelu(self.conv2(x1))
        if self.skip_connection:
            x2 = x2 + x0
        return self.conv4(lrelu(self.conv3(x2)))


@ARCH_REGISTRY.register()
class MOD(nn.Module):
    """Mixture of discriminators with hard expert routing (reference
    :39-110), as the JAX module lays it out: a 7-conv BN feature extractor
    (``fe_conv*``, ``fe_bn*``); routing = softmax(feature @ ``w_gating1``)
    per pixel; the code reduction lrelu(lrelu(``cr_body``(feature)) *
    ``cr_weight``) split into ``num_expert`` parts; one classifier
    (``cls_fc1``, ``cls_fc2``) shared by every expert, the argmax expert's
    logit taken per pixel.  Pixels are the (b, h * w) tokens in row-major
    order, as the JAX module flattens NHWC.  Returns ``(logits (b, hw, 1),
    routing (b, hw, E), parts [E x (b, hw, c)], ortho_weight (E, c))``."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64, num_expert: int = 12):
        super().__init__()
        nf, self.num_expert = num_feat, num_expert
        self.fe_conv0 = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        self.fe_conv1 = nn.Conv2d(nf, nf, 4, 2, 1, bias=False)
        self.fe_conv2 = nn.Conv2d(nf, nf * 2, 3, 1, 1, bias=False)
        self.fe_conv3 = nn.Conv2d(nf * 2, nf * 2, 4, 2, 1, bias=False)
        self.fe_conv4 = nn.Conv2d(nf * 2, nf * 4, 3, 1, 1, bias=False)
        self.fe_conv5 = nn.Conv2d(nf * 4, nf * 4, 3, 1, 1, bias=False)
        self.fe_conv6 = nn.Conv2d(nf * 4, nf * 4, 3, 1, 1, bias=False)
        for i, c in enumerate((nf, nf * 2, nf * 2, nf * 4, nf * 4, nf * 4), start=1):
            setattr(self, f"fe_bn{i}", BatchNorm2d(c))
        c = nf * 4
        self.w_gating1 = nn.Parameter(torch.zeros(c, num_expert))
        self.cr_body = nn.Linear(c, c * num_expert)
        self.cr_weight = nn.Parameter(torch.zeros(1, 1, c * num_expert))
        self.cls_fc1 = nn.Linear(c, num_feat // 2)
        self.cls_fc2 = nn.Linear(num_feat // 2, 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Convs and linears from N(0, 1 / fan_in), unit batch norms, and the
        gating and transform weights from N(0, 1), as flax draws them."""
        normal_init_(self, generator)
        self.w_gating1.copy_(torch.randn(self.w_gating1.shape, generator=generator))
        self.cr_weight.copy_(torch.randn(self.cr_weight.shape, generator=generator))

    def forward(self, x):
        def lrelu(v):
            return F.leaky_relu(v, 0.2)

        f = lrelu(self.fe_conv0(x))
        for i in range(1, 7):
            f = lrelu(getattr(self, f"fe_bn{i}")(getattr(self, f"fe_conv{i}")(f)))
        b, c, h, w = f.shape
        feature = f.permute(0, 2, 3, 1).reshape(b, h * w, c)
        routing = torch.softmax(feature @ self.w_gating1, dim=-1)
        proj = lrelu(lrelu(self.cr_body(feature)) * self.cr_weight)
        parts = list(torch.split(proj, c, dim=-1))
        top = torch.argmax(routing, dim=-1)
        stacked = torch.stack([self.cls_fc2(lrelu(self.cls_fc1(p))) for p in parts], dim=-1)
        output = torch.gather(stacked, -1, top[..., None, None])[..., 0]
        return output, routing, parts, self.cr_weight.reshape(self.num_expert, -1)


@ARCH_REGISTRY.register()
class Discriminator_VGG_192(VGGStyleDiscriminator):
    """192-input VGG-style D (reference :194-255): layer for layer
    ``VGGStyleDiscriminator(input_size=192)``, whose names and weight carry
    it shares."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64):
        super().__init__(num_in_ch, num_feat, 192)


@ARCH_REGISTRY.register()
class DiscriminatorSN_VGG_192(nn.Module):
    """Spectral-norm VGG D for 192 inputs (reference :258-323): ``conv0_0``
    plain and biased, ``conv0_1`` to ``conv5_1`` spectrally normalized
    (``SNConv2d``, flax's power iteration) and bias-free, then ``linear1``
    and ``linear2`` on the NCHW-flattened 3 x 3 map."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64):
        super().__init__()
        nf = num_feat
        self.conv0_0 = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        self.conv0_1 = SNConv2d(nf, nf, 4, 2)
        chans = [nf, nf * 2, nf * 4, nf * 8, nf * 8, nf * 8]
        for i in range(1, 6):
            setattr(self, f"conv{i}_0", SNConv2d(chans[i - 1], chans[i], 3))
            setattr(self, f"conv{i}_1", SNConv2d(chans[i], chans[i], 4, 2))
        self.linear1 = nn.Linear(nf * 8 * 3 * 3, 100)
        self.linear2 = nn.Linear(100, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_sn_discriminator(self, generator)

    def forward(self, x):
        if x.shape[-2:] != (192, 192):
            raise ValueError(f"input must be 192x192, got {tuple(x.shape)}")
        lrelu = lambda v: F.leaky_relu(v, 0.2)  # noqa: E731
        feat = lrelu(self.conv0_1(lrelu(self.conv0_0(x))))
        for i in range(1, 6):
            feat = lrelu(getattr(self, f"conv{i}_1")(lrelu(getattr(self, f"conv{i}_0")(feat))))
        return self.linear2(lrelu(self.linear1(feat.flatten(1))))


@ARCH_REGISTRY.register()
class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator (taming / pix2pix layout; the reference's CFW
    adversarial loss uses it): ``conv0`` (stride 2, biased), ``conv1`` to
    ``conv{n_layers - 1}`` (stride 2) and ``conv{n_layers}`` (stride 1),
    each bias-free with a flax-rule batch norm ``bn{k}``, then ``conv_out``
    to a 1-channel logit map; every conv is 4 x 4 with padding 1."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = nn.Conv2d(input_nc, ndf, 4, 2, 1)
        cin = ndf
        for n in range(1, n_layers + 1):
            cout = ndf * min(2 ** n, 8)
            setattr(self, f"conv{n}", nn.Conv2d(cin, cout, 4, 2 if n < n_layers else 1, 1,
                                                bias=False))
            setattr(self, f"bn{n}", BatchNorm2d(cout))
            cin = cout
        self.conv_out = nn.Conv2d(cin, 1, 4, 1, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_init_(self, generator)

    def forward(self, x):
        h = F.leaky_relu(self.conv0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            h = F.leaky_relu(getattr(self, f"bn{n}")(getattr(self, f"conv{n}")(h)), 0.2)
        return self.conv_out(h)
