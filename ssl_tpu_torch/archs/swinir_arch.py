"""SwinIR — transformer SR with shifted-window attention
(reference: archs/swinir_arch.py:694-979).

Counterpart of ``ssl_tpu/archs/swinir_arch.py``.  The transformer body runs
channels-last (b, h, w, c), as the JAX module does; the convolutions take
NCHW.  The window attention is plain ``torch.matmul`` and ``softmax``
(the JAX module's einsum), with the relative position bias table
((2w - 1)^2, heads) and, in shifted blocks, the -100 mask of the standard
Swin scheme.  LayerNorm eps is 1e-5 everywhere and GELU is the tanh
approximation (flax's ``nn.gelu``).

The input is always padded at the bottom and right by ``np.pad``'s
"symmetric" mirror up to the next multiple of the window beyond its size (a
full extra window when it is already aligned), as the reference's
``check_image_size`` does, and the output is cropped back.

Module names follow the reference state dict (``patch_embed.norm``,
``layers.{i}.residual_group.blocks.{j}.{norm1,attn.qkv,attn.proj,
attn.relative_position_bias_table,norm2,mlp.fc1,mlp.fc2}``,
``layers.{i}.conv``, ``conv_before_upsample.0``, ``upsample.{2k}``)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssl_tpu_torch.archs.arch_util import normal_init_, pad_symmetric
from ssl_tpu_torch.utils.registry import ARCH_REGISTRY

RGB_MEAN = (0.4488, 0.4371, 0.4040)


@lru_cache(maxsize=None)
def _rel_pos_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (window - 1)
    return (rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]).reshape(-1)


@lru_cache(maxsize=None)
def _attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(windows, w^2, w^2): 0 within a region of the shifted image, -100
    between regions (the 9 regions of the standard Swin scheme)."""
    img_mask = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    mask = img_mask.reshape(h // window, window, w // window, window)
    mask = mask.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = mask[:, None, :] - mask[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.window, self.num_heads = window, num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_rel_pos_index(window)), persistent=False)

    def forward(self, x, mask=None):
        bw, n, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x).reshape(bw, n, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul(q * hd ** -0.5, k.transpose(-2, -1))
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(n, n, self.num_heads).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, self.num_heads, n, n) + mask[None, :, None]) \
                .reshape(bw, self.num_heads, n, n)
        out = torch.matmul(torch.softmax(attn, dim=-1), v)
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SwinBlock(nn.Module):
    """A Swin transformer block on (b, h, w, c), h and w multiples of the
    window; ``shift`` > 0 rolls by -shift before the attention and back after."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 2.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        b, h, w, c = x.shape
        win, shift = self.window, self.shift
        y = self.norm1(x)
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = torch.from_numpy(_attn_mask(h, w, win, shift)).to(x.device)
        y = y.reshape(b, h // win, win, w // win, win, c).permute(0, 1, 3, 2, 4, 5)
        y = self.attn(y.reshape(-1, win * win, c), mask)
        y = y.reshape(b, h // win, w // win, win, win, c).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(b, h, w, c)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class ResidualGroup(nn.Module):
    def __init__(self, dim, depth, num_heads, window, mlp_ratio):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window, 0 if i % 2 == 0 else window // 2, mlp_ratio)
            for i in range(depth))

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class RSTB(nn.Module):
    """Residual Swin Transformer Block: ``depth`` Swin blocks (no shift and
    shift alternating) and a 3x3 conv, around a skip.  The JAX module scans
    the (no-shift, shift) pairs under remat when the depth is even and above
    2; that is a TPU schedule of the same function."""

    def __init__(self, dim, depth, num_heads, window, mlp_ratio=2.0):
        super().__init__()
        self.residual_group = ResidualGroup(dim, depth, num_heads, window, mlp_ratio)
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x):
        y = self.residual_group(x)
        return self.conv(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) + x


class PatchEmbed(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)


@ARCH_REGISTRY.register()
class SwinIR(nn.Module):
    """upsampler: 'pixelshuffle' (classical), 'pixelshuffledirect'
    (lightweight), 'nearest+conv' (real-world) or '' (same size)."""

    def __init__(self, upscale: int = 4, in_chans: int = 3, img_size: int = 64,
                 window_size: int = 8, img_range: float = 1.0, depths=(6, 6, 6, 6),
                 embed_dim: int = 96, num_heads=(6, 6, 6, 6), mlp_ratio: float = 2.0,
                 upsampler: str = "pixelshuffle", resi_connection: str = "1conv",
                 num_feat: int = 64, patch_norm: bool = True):
        super().__init__()
        if resi_connection != "1conv":
            raise NotImplementedError(f"resi_connection {resi_connection!r}: only '1conv' "
                                      "is ported (as in the JAX package)")
        self.upscale, self.in_chans, self.window = upscale, in_chans, window_size
        self.img_range, self.upsampler = float(img_range), upsampler
        self.register_buffer("mean", torch.tensor(RGB_MEAN if in_chans == 3 else (0.0,))
                             .reshape(1, -1, 1, 1), persistent=False)
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, 1, 1)
        self.patch_embed = PatchEmbed(embed_dim) if patch_norm else None
        self.layers = nn.ModuleList(RSTB(embed_dim, d, nh, window_size, mlp_ratio)
                                    for d, nh in zip(depths, num_heads))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, 1, 1)
        if upsampler in ("pixelshuffle", "nearest+conv"):
            self.conv_before_upsample = nn.Sequential(nn.Conv2d(embed_dim, num_feat, 3, 1, 1))
        if upsampler == "pixelshuffle":
            ups, s = [], upscale
            while s > 1:
                f = 3 if s % 3 == 0 else 2
                ups += [nn.Conv2d(num_feat, num_feat * f * f, 3, 1, 1), nn.PixelShuffle(f)]
                s //= f
            self.upsample = nn.Sequential(*ups)
            self.conv_last = nn.Conv2d(num_feat, in_chans, 3, 1, 1)
        elif upsampler == "pixelshuffledirect":
            self.upsample = nn.Sequential(
                nn.Conv2d(embed_dim, in_chans * upscale ** 2, 3, 1, 1), nn.PixelShuffle(upscale))
        elif upsampler == "nearest+conv":
            self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            if upscale == 4:
                self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            self.conv_last = nn.Conv2d(num_feat, in_chans, 3, 1, 1)
        elif upsampler == "":
            self.conv_last = nn.Conv2d(embed_dim, in_chans, 3, 1, 1)
        else:
            raise ValueError(f"unknown upsampler {upsampler!r}")

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Convs and linears from N(0, 1 / fan_in) with zero biases, layer
        norms 1 and 0, bias tables from N(0, 0.02^2) cut at 2 sigma."""
        normal_init_(self, generator)
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, WindowAttention):
                t = m.relative_position_bias_table
                t.copy_((torch.randn(t.shape, generator=generator) * 0.02).clamp(-0.04, 0.04))

    def forward(self, x):
        h0, w0 = x.shape[-2:]
        win = self.window
        x = pad_symmetric(x, (h0 // win + 1) * win - h0, (w0 // win + 1) * win - w0)
        x = (x - self.mean) * self.img_range

        feat = self.conv_first(x)
        body = feat.permute(0, 2, 3, 1)
        if self.patch_embed is not None:
            body = self.patch_embed.norm(body)
        for layer in self.layers:
            body = layer(body)
        body = self.norm(body).permute(0, 3, 1, 2)
        feat = feat + self.conv_after_body(body)

        if self.upsampler == "pixelshuffle":
            feat = F.leaky_relu(self.conv_before_upsample(feat), 0.01)
            out = self.conv_last(self.upsample(feat))
        elif self.upsampler == "pixelshuffledirect":
            out = self.upsample(feat)
        elif self.upsampler == "nearest+conv":
            lrelu = lambda v: F.leaky_relu(v, 0.2)  # noqa: E731
            feat = F.leaky_relu(self.conv_before_upsample(feat), 0.01)
            feat = lrelu(self.conv_up1(F.interpolate(feat, scale_factor=2, mode="nearest")))
            if self.upscale == 4:
                feat = lrelu(self.conv_up2(F.interpolate(feat, scale_factor=2, mode="nearest")))
            out = self.conv_last(lrelu(self.conv_hr(feat)))
        else:
            out = x + self.conv_last(feat)
        out = out / self.img_range + self.mean
        return out[:, :, : h0 * self.upscale, : w0 * self.upscale]
