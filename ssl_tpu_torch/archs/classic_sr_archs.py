"""Classic SR CNNs of the vendored BasicSR zoo: EDSR (edsr_arch.py), RCAN
(rcan_arch.py) and ECBSR (ecbsr_arch.py, the edge-oriented conv block net).

Counterpart of ``ssl_tpu/archs/classic_sr_archs.py``: no SSL recipe trains
them; they are registered so that an option file naming them builds.  Module
names follow the reference state dicts (EDSR ``body.{i}.conv1/conv2``,
``upsample.{0,2}``; RCAN ``body.{g}.residual_group.{b}.rcab.{0,2,3}`` with
``.3.attention.{1,3}``; ECBSR ``backbone.{i}`` with ``k0``/``b0``/``k1``/
``b1``/``scale``/``bias`` parameters).  ECBSR runs the training-time
multi-branch form, with the reference's border padded by the 1x1 conv's
bias."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ssl_tpu_torch.archs.arch_util import make_layer, normal_init_
from ssl_tpu_torch.archs.srresnet_arch import ResidualBlockNoBN
from ssl_tpu_torch.utils.registry import ARCH_REGISTRY


def upsample(scale: int, num_feat: int) -> nn.Sequential:
    """Pixel-shuffle upsampler for 2^n and 3 (reference arch_util.py:78-100)."""
    layers = []
    if scale & (scale - 1) == 0:
        for _ in range(scale.bit_length() - 1):
            layers += [nn.Conv2d(num_feat, 4 * num_feat, 3, 1, 1), nn.PixelShuffle(2)]
    elif scale == 3:
        layers += [nn.Conv2d(num_feat, 9 * num_feat, 3, 1, 1), nn.PixelShuffle(3)]
    else:
        raise ValueError(f"scale {scale} is not supported. Supported scales: 2^n and 3.")
    return nn.Sequential(*layers)


class _MeanShiftNet(nn.Module):
    """x -> (x - mean) * img_range -> body -> / img_range + mean."""

    def __init__(self, img_range: float, rgb_mean):
        super().__init__()
        self.img_range = img_range
        self.register_buffer("mean", torch.tensor(rgb_mean, dtype=torch.float32).view(1, 3, 1, 1),
                             persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_init_(self, generator)

    def forward(self, x):
        x = (x - self.mean) * self.img_range
        feat = self.conv_first(x)
        feat = feat + self.conv_after_body(self.body(feat))
        return self.conv_last(self.upsample(feat)) / self.img_range + self.mean


@ARCH_REGISTRY.register()
class EDSR(_MeanShiftNet):
    """EDSR: mean-shifted residual CNN (reference edsr_arch.py:9-61)."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_block: int = 16, upscale: int = 4, res_scale: float = 1.0,
                 img_range: float = 255.0, rgb_mean=(0.4488, 0.4371, 0.4040)):
        super().__init__(img_range, rgb_mean)
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = make_layer(ResidualBlockNoBN, num_block, num_feat=num_feat,
                               res_scale=res_scale)
        self.conv_after_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.upsample = upsample(upscale, num_feat)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)


class _ChannelAttention(nn.Module):
    """Global average pool, 1x1 squeeze to num_feat // squeeze_factor, relu,
    1x1 expand, sigmoid gate (reference rcan_arch.py:8-24)."""

    def __init__(self, num_feat: int, squeeze_factor: int = 16):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(num_feat, num_feat // squeeze_factor, 1),
            nn.ReLU(inplace=True), nn.Conv2d(num_feat // squeeze_factor, num_feat, 1),
            nn.Sigmoid())

    def forward(self, x):
        return x * self.attention(x)


class _RCAB(nn.Module):
    """x + res_scale * CA(conv(relu(conv(x)))) (rcan_arch.py:27-46)."""

    def __init__(self, num_feat: int, squeeze_factor: int = 16, res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.rcab = nn.Sequential(nn.Conv2d(num_feat, num_feat, 3, 1, 1), nn.ReLU(True),
                                  nn.Conv2d(num_feat, num_feat, 3, 1, 1),
                                  _ChannelAttention(num_feat, squeeze_factor))

    def forward(self, x):
        return x + self.rcab(x) * self.res_scale


class _ResidualGroup(nn.Module):
    def __init__(self, num_feat: int, num_block: int, squeeze_factor: int = 16,
                 res_scale: float = 1.0):
        super().__init__()
        self.residual_group = make_layer(_RCAB, num_block, num_feat=num_feat,
                                         squeeze_factor=squeeze_factor, res_scale=res_scale)
        self.conv = nn.Conv2d(num_feat, num_feat, 3, 1, 1)

    def forward(self, x):
        return x + self.conv(self.residual_group(x))


@ARCH_REGISTRY.register()
class RCAN(_MeanShiftNet):
    """Residual channel attention network (reference rcan_arch.py:71-135)."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_group: int = 10, num_block: int = 16, squeeze_factor: int = 16,
                 upscale: int = 4, res_scale: float = 1.0, img_range: float = 255.0,
                 rgb_mean=(0.4488, 0.4371, 0.4040)):
        super().__init__(img_range, rgb_mean)
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = make_layer(_ResidualGroup, num_group, num_feat=num_feat,
                               num_block=num_block, squeeze_factor=squeeze_factor,
                               res_scale=res_scale)
        self.conv_after_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.upsample = upsample(upscale, num_feat)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)


# the fixed edge operators of ecbsr_arch.py:50-101
_MASKS = {
    "conv1x1-sobelx": ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0)),
    "conv1x1-sobely": ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0)),
    "conv1x1-laplacian": ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0)),
}


def _bias_pad(y0: torch.Tensor, b0: torch.Tensor) -> torch.Tensor:
    """Pad by 1 with the 1x1 conv's bias on the border (ecbsr_arch.py:108-126):
    the following 3x3 sees the bias, not zero, outside the image."""
    yp = F.pad(y0, (1, 1, 1, 1))
    b = b0.view(1, -1, 1, 1)
    yp[:, :, 0:1, :] = b
    yp[:, :, -1:, :] = b
    yp[:, :, :, 0:1] = b
    yp[:, :, :, -1:] = b
    return yp


class _SeqConv3x3(nn.Module):
    """conv1x1 -> bias pad -> a 3x3 conv (``conv1x1-conv3x3``, the 1x1 conv
    expanding to out * depth_multiplier) or a fixed edge operator scaled per
    channel (``conv1x1-sobelx/-sobely/-laplacian``, depthwise)."""

    def __init__(self, seq_type: str, in_ch: int, out_ch: int, depth_multiplier: float = 2.0):
        super().__init__()
        self.seq_type = seq_type
        if seq_type == "conv1x1-conv3x3":
            mid = int(out_ch * depth_multiplier)
            self.k0 = nn.Parameter(torch.zeros(mid, in_ch, 1, 1))
            self.b0 = nn.Parameter(torch.zeros(mid))
            self.k1 = nn.Parameter(torch.zeros(out_ch, mid, 3, 3))
            self.b1 = nn.Parameter(torch.zeros(out_ch))
        else:
            self.k0 = nn.Parameter(torch.zeros(out_ch, in_ch, 1, 1))
            self.b0 = nn.Parameter(torch.zeros(out_ch))
            self.scale = nn.Parameter(torch.zeros(out_ch, 1, 1, 1))
            self.bias = nn.Parameter(torch.zeros(out_ch))
            self.register_buffer("mask", torch.tensor(_MASKS[seq_type]).expand(
                out_ch, 1, 3, 3).clone(), persistent=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)
        normal(self.k0, self.k0.shape[1] ** -0.5)
        self.b0.zero_()
        if self.seq_type == "conv1x1-conv3x3":
            normal(self.k1, self.k1[0].numel() ** -0.5)
            self.b1.zero_()
        else:
            normal(self.scale, 1e-3)
            normal(self.bias, 1e-3)

    def forward(self, x):
        y0 = _bias_pad(F.conv2d(x, self.k0, self.b0), self.b0)
        if self.seq_type == "conv1x1-conv3x3":
            return F.conv2d(y0, self.k1, self.b1)
        return F.conv2d(y0, self.scale * self.mask, self.bias, groups=self.bias.shape[0])


class _ECB(nn.Module):
    """Edge-oriented conv block, training-time multi-branch form
    (ecbsr_arch.py:156-212)."""

    def __init__(self, in_ch: int, out_ch: int, depth_multiplier: float = 2.0,
                 act_type: str = "prelu", with_idt: bool = False):
        super().__init__()
        self.act_type = act_type
        self.with_idt = with_idt and in_ch == out_ch
        self.conv3x3 = nn.Conv2d(in_ch, out_ch, 3, 1, 1)
        self.conv1x1_3x3 = _SeqConv3x3("conv1x1-conv3x3", in_ch, out_ch, depth_multiplier)
        self.conv1x1_sbx = _SeqConv3x3("conv1x1-sobelx", in_ch, out_ch)
        self.conv1x1_sby = _SeqConv3x3("conv1x1-sobely", in_ch, out_ch)
        self.conv1x1_lpl = _SeqConv3x3("conv1x1-laplacian", in_ch, out_ch)
        if act_type == "prelu":
            self.act = nn.PReLU(num_parameters=out_ch, init=0.25)
        elif act_type not in ("relu", "softplus", "linear"):
            raise ValueError(f"act_type {act_type} not supported")

    def forward(self, x):
        y = (self.conv3x3(x) + self.conv1x1_3x3(x) + self.conv1x1_sbx(x) + self.conv1x1_sby(x)
             + self.conv1x1_lpl(x))
        if self.with_idt:
            y = y + x
        if self.act_type == "prelu":
            return self.act(y)
        if self.act_type == "relu":
            return F.relu(y)
        if self.act_type == "softplus":
            return F.softplus(y)
        return y


@ARCH_REGISTRY.register()
class ECBSR(nn.Module):
    """Edge-oriented conv block SR net (reference ecbsr_arch.py:235-275)."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_block: int = 4,
                 num_channel: int = 16, with_idt: bool = False, act_type: str = "prelu",
                 scale: int = 4):
        super().__init__()
        self.num_in_ch = num_in_ch
        self.scale = scale
        blocks = [_ECB(num_in_ch, num_channel, 2.0, act_type, with_idt)]
        blocks += [_ECB(num_channel, num_channel, 2.0, act_type, with_idt)
                   for _ in range(num_block)]
        blocks.append(_ECB(num_channel, num_out_ch * scale * scale, 2.0, "linear", with_idt))
        self.backbone = nn.Sequential(*blocks)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_init_(self, generator)
        for m in self.modules():
            if isinstance(m, _SeqConv3x3):
                m.reset_parameters(generator)
            elif isinstance(m, nn.PReLU):
                m.weight.fill_(0.25)

    def forward(self, x):
        s2 = self.scale * self.scale
        shortcut = torch.repeat_interleave(x, s2, dim=1) if self.num_in_ch > 1 else x
        return F.pixel_shuffle(self.backbone(x) + shortcut, self.scale)
