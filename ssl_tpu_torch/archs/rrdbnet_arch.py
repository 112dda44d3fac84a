"""RRDBNet — ESRGAN / RealESRGAN generator (reference: archs/rrdbnet_arch.py:67).

Counterpart of ``ssl_tpu/archs/rrdbnet_arch.py::RRDBNet``.  The dense block
uses the plain concat form; the JAX package's ``split_convs`` regrouping,
scanned trunk, remat and unroll are TPU schedules of the same math and have
no counterpart here.  Module names follow the reference state dict
(``body.{i}.rdb{j}.conv{k}``), so reference ``.pth`` files load directly.

``compute_dtype: bfloat16`` follows the JAX module's casts: the input is
cast before ``conv_first``, every conv, ``leaky_relu``, residual add and
upsampling runs in bf16 on bf16 copies of the float32 parameters, and the
image comes back as float32."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ssl_tpu_torch.archs.arch_util import Conv2d, compute_dtype_of, make_layer, normal_init_
from ssl_tpu_torch.utils.registry import ARCH_REGISTRY


class ResidualDenseBlock(nn.Module):
    """5-conv dense block with 0.2 residual scaling (reference rrdbnet_arch.py:12-47)."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        self.conv1 = Conv2d(num_feat, num_grow_ch, 3, 1, 1)
        self.conv2 = Conv2d(num_feat + num_grow_ch, num_grow_ch, 3, 1, 1)
        self.conv3 = Conv2d(num_feat + 2 * num_grow_ch, num_grow_ch, 3, 1, 1)
        self.conv4 = Conv2d(num_feat + 3 * num_grow_ch, num_grow_ch, 3, 1, 1)
        self.conv5 = Conv2d(num_feat + 4 * num_grow_ch, num_feat, 3, 1, 1)

    def forward(self, x):
        lrelu = lambda v: F.leaky_relu(v, 0.2)  # noqa: E731
        x1 = lrelu(self.conv1(x))
        x2 = lrelu(self.conv2(torch.cat((x, x1), 1)))
        x3 = lrelu(self.conv3(torch.cat((x, x1, x2), 1)))
        x4 = lrelu(self.conv4(torch.cat((x, x1, x2, x3), 1)))
        x5 = self.conv5(torch.cat((x, x1, x2, x3, x4), 1))
        return x5 * 0.2 + x


def init_rrdb_net(net: nn.Module, generator: torch.Generator) -> None:
    """N(0, 1 / (3 fan_in)) everywhere, the variance of torch's default init
    that the reference keeps outside the dense blocks, then the residual
    dense blocks' convs scaled as the reference's ``default_init_weights``
    (gain 2, x0.1).  (flax's default, variance 1 / fan_in, which the JAX
    modules draw, gives a full-width RRDBNet's SR of a [0, 1] input a
    standard deviation of ~9; this init ~0.27.)"""
    normal_init_(net, generator, gain=1 / 3)
    for m in net.modules():
        if isinstance(m, ResidualDenseBlock):
            normal_init_(m, generator, gain=2.0, scale=0.1)


class RRDB(nn.Module):
    """Residual-in-residual dense block (reference rrdbnet_arch.py:50-64)."""

    def __init__(self, num_feat: int, num_grow_ch: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


@ARCH_REGISTRY.register()
class RRDBNet(nn.Module):
    """ESRGAN generator (reference rrdbnet_arch.py:67-140).  For scale 1 and
    2 the input is pixel-unshuffled so the trunk works at 1/4 of the x4
    output's resolution.  The JAX module's ``remat_policy`` and
    ``scan_unroll`` schedule its scanned trunk; eager PyTorch saves every
    activation, which is ``remat_policy: none``, and has no unroll to set.
    Any other remat policy raises (ROADMAP.md queues it)."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, scale: int = 4,
                 num_feat: int = 64, num_block: int = 23, num_grow_ch: int = 32,
                 compute_dtype=None, remat_policy=None, scan_unroll: int = 1):
        super().__init__()
        if remat_policy not in (None, "none"):
            raise NotImplementedError(f"remat_policy={remat_policy!r}: the port saves every "
                                      "activation (remat_policy: none); recompute is queued "
                                      "in ROADMAP.md")
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.scale = scale
        if scale == 2:
            num_in_ch *= 4
        elif scale == 1:
            num_in_ch *= 16
        self.conv_first = Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = make_layer(RRDB, num_block, num_feat=num_feat, num_grow_ch=num_grow_ch)
        self.conv_body = Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up1 = Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up2 = Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_hr = Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = Conv2d(num_feat, num_out_ch, 3, 1, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_rrdb_net(self, generator)

    def forward(self, x):
        lrelu = lambda v: F.leaky_relu(v, 0.2)  # noqa: E731
        if self.scale == 2:
            feat = F.pixel_unshuffle(x, 2)
        elif self.scale == 1:
            feat = F.pixel_unshuffle(x, 4)
        else:
            feat = x
        if self.compute_dtype is not None:
            feat = feat.to(self.compute_dtype)
        feat = self.conv_first(feat)
        feat = feat + self.conv_body(self.body(feat))
        feat = lrelu(self.conv_up1(F.interpolate(feat, scale_factor=2, mode="nearest")))
        feat = lrelu(self.conv_up2(F.interpolate(feat, scale_factor=2, mode="nearest")))
        out = self.conv_last(lrelu(self.conv_hr(feat)))
        return out if self.compute_dtype is None else out.float()
