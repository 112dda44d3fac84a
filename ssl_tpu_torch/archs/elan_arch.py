"""ELAN — Efficient Long-range Attention Network for image SR
(reference: archs/elan_arch.py:237-320).

Counterpart of ``ssl_tpu/archs/elan_arch.py``.  The body runs channels-last
(b, h, w, c), as the JAX module does: its 1x1 convolutions are ``nn.Linear``
layers and its LayerNorms normalize the channels (eps 1e-5).  The head and
tail are 3x3 convolutions on NCHW.

* ``shift_channels``: five channel groups of c // 5 (the remainder joins the
  last, unshifted group) move one pixel left, right, up and down, the
  vacated border filled with zeros (the reference's fixed depthwise
  ``ShiftConv2d``).
* ``GMSA``: the channels split into three groups, each attending within
  windows of its own size; odd blocks roll each group by -(w // 2) first
  (``jnp.roll`` by Python's ``-w // 2``) and back by w // 2 after.  With
  ``n_share`` > 0 the blocks after the first of an ELAB reuse its
  attention maps.
* The input is reflect-padded to a multiple of the windows' least common
  multiple only where it is not one already; the output is cropped back.
  ``img_range`` scales the mean-subtracted input (255 by default)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ssl_tpu_torch.archs.arch_util import normal_init_, pad_reflect
from ssl_tpu_torch.utils.registry import ARCH_REGISTRY


def shift_channels(x: torch.Tensor) -> torch.Tensor:
    """(b, h, w, c): groups 0-3 of c // 5 channels take their right, left,
    lower and upper neighbour (zero past the border); the rest stay."""
    g = x.shape[-1] // 5
    out = torch.zeros_like(x)
    out[:, :, :-1, 0 * g:1 * g] = x[:, :, 1:, 0 * g:1 * g]
    out[:, :, 1:, 1 * g:2 * g] = x[:, :, :-1, 1 * g:2 * g]
    out[:, :-1, :, 2 * g:3 * g] = x[:, 1:, :, 2 * g:3 * g]
    out[:, 1:, :, 3 * g:4 * g] = x[:, :-1, :, 3 * g:4 * g]
    out[..., 4 * g:] = x[..., 4 * g:]
    return out


class ShiftConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Linear(cin, cout)

    def forward(self, x):
        return self.conv(shift_channels(x))


class LFE(nn.Module):
    """Local feature extraction: shift-conv expand, ReLU (or GELU), shift-conv."""

    def __init__(self, channels: int, exp_ratio: int = 2, act_type: str = "relu"):
        super().__init__()
        self.act_type = act_type
        self.conv0 = ShiftConv(channels, channels * exp_ratio)
        self.conv1 = ShiftConv(channels * exp_ratio, channels)

    def forward(self, x):
        y = self.conv0(x)
        y = F.relu(y) if self.act_type == "relu" else F.gelu(y, approximate="tanh")
        return self.conv1(y)


def _window_partition(x, wsize):
    b, h, w, c = x.shape
    x = x.reshape(b, h // wsize, wsize, w // wsize, wsize, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wsize * wsize, c)


def _window_merge(x, wsize, h, w):
    c = x.shape[-1]
    b = x.shape[0] // ((h // wsize) * (w // wsize))
    x = x.reshape(b, h // wsize, w // wsize, wsize, wsize, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


class GMSA(nn.Module):
    """Group multi-scale self-attention; ``calc_attn`` False reuses the maps
    it is given."""

    def __init__(self, channels: int, shifts: int = 0, window_sizes=(4, 8, 12),
                 calc_attn: bool = True):
        super().__init__()
        self.shifts, self.window_sizes = shifts, tuple(window_sizes)
        width = channels * 2 if calc_attn else channels
        self.project_inp = nn.Linear(channels, width)
        self.norm = nn.LayerNorm(width, eps=1e-5)
        self.project_out = nn.Linear(channels, channels)

    def forward(self, x, prev_atns=None):
        b, h, w, c = x.shape
        y = self.norm(self.project_inp(x))
        part = y.shape[-1] // 3
        xs = torch.split(y, [part, part, y.shape[-1] - 2 * part], dim=-1)
        ys, atns = [], []
        for idx, x_ in enumerate(xs):
            wsize = self.window_sizes[idx]
            if self.shifts > 0:
                x_ = torch.roll(x_, (-wsize // 2, -wsize // 2), dims=(1, 2))
            if prev_atns is None:
                qv = _window_partition(x_, wsize)
                q, v = qv[..., :qv.shape[-1] // 2], qv[..., qv.shape[-1] // 2:]
                atn = torch.softmax(torch.matmul(q, q.transpose(1, 2)), dim=-1)
                atns.append(atn)
            else:
                v, atn = _window_partition(x_, wsize), prev_atns[idx]
            y_ = _window_merge(torch.matmul(atn, v), wsize, h, w)
            if self.shifts > 0:
                y_ = torch.roll(y_, (wsize // 2, wsize // 2), dims=(1, 2))
            ys.append(y_)
        return self.project_out(torch.cat(ys, dim=-1)), (atns if prev_atns is None else prev_atns)


class ELAB(nn.Module):
    def __init__(self, channels, exp_ratio=2, shifts=0, window_sizes=(4, 8, 12),
                 shared_depth=1):
        super().__init__()
        self.lfe = nn.ModuleList(LFE(channels, exp_ratio) for _ in range(1 + shared_depth))
        self.gmsa = nn.ModuleList(GMSA(channels, shifts, window_sizes, calc_attn=(i == 0))
                                  for i in range(1 + shared_depth))

    def forward(self, x):
        atn = None
        for lfe, gmsa in zip(self.lfe, self.gmsa):
            x = lfe(x) + x
            y, atn = gmsa(x, atn)
            x = y + x
        return x


@ARCH_REGISTRY.register()
class ELAN(nn.Module):

    def __init__(self, scale: int = 4, img_range: float = 255.0, colors: int = 3,
                 window_sizes=(4, 8, 16), m_elan: int = 36, c_elan: int = 180,
                 n_share: int = 0, r_expand: int = 2,
                 rgb_mean=(0.4488, 0.4371, 0.4040)):
        super().__init__()
        self.scale, self.img_range = scale, float(img_range)
        self.window_lcm = math.lcm(*window_sizes)
        self.register_buffer("mean", torch.tensor(tuple(rgb_mean)).reshape(1, -1, 1, 1),
                             persistent=False)
        self.head = nn.Conv2d(colors, c_elan, 3, 1, 1)
        self.body = nn.ModuleList(
            ELAB(c_elan, r_expand, i % 2, window_sizes, n_share)
            for i in range(m_elan // (1 + n_share)))
        out_ch = colors * scale ** 2 if scale != 1 else colors
        self.tail = nn.Conv2d(c_elan, out_ch, 3, 1, 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Convs and linears from N(0, 1 / (3 fan_in)), the variance of
        torch's default init that the reference ELAN keeps, with zero biases;
        layer norms 1 and 0.  (flax's default, variance 1 / fan_in, which the
        JAX module draws, compounds over the 72 residual branches of the full
        width: its SR of a [0, 1] input has a standard deviation of ~350.)"""
        normal_init_(self, generator, gain=1 / 3)
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, x):
        h0, w0 = x.shape[-2:]
        wsize = self.window_lcm
        ph, pw = (wsize - h0 % wsize) % wsize, (wsize - w0 % wsize) % wsize
        if ph or pw:
            x = pad_reflect(x, ph, pw)
        x = (x - self.mean) * self.img_range
        feat = self.head(x)
        res = feat.permute(0, 2, 3, 1)
        for block in self.body:
            res = block(res)
        res = res.permute(0, 3, 1, 2) + feat
        out = self.tail(res)
        if self.scale != 1:
            out = F.pixel_shuffle(out, self.scale)
        out = out / self.img_range + self.mean
        return out[:, :, : h0 * self.scale, : w0 * self.scale]
