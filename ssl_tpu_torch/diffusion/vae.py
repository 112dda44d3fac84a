"""AutoencoderKL, the latent-diffusion VAE (ldm/models/autoencoder.py:291).

Counterpart of ``ssl_tpu/diffusion/vae.py`` (``AutoencoderKL`` and its
Encoder, Decoder, ResnetBlock and AttnBlock), in NCHW, with ldm's module
names (``encoder.down.0.block.0.norm1``, ``decoder.mid.attn_1.q``, ...: the
table of ``convert_ldm_vae``), so SD/ldm first-stage checkpoints keep their
keys.  GroupNorm eps is 1e-6, with gcd(c, 32) groups where c is not a
multiple of 32; the encoder's stride-2 convs pad (0, 1) on each axis; the
decoder upsamples nearest x2.  The mid-block attention is one head of width
c through ``ops/attention.py::sdp_attention`` (K2 on CUDA when eligible).

Decoder remat as in the JAX package (``ssl_tpu/diffusion/vae.py:113-169``):
with ``remat_decoder_blocks`` (the default) and grad enabled, every decoder
block (mid block_1, attn_1, block_2 and each ``up`` ResnetBlock) runs under
``torch.utils.checkpoint``, so a differentiable decode keeps only the block
boundaries and replays one block at a time in the backward;
``remat_skip_lowres = k`` exempts the ResnetBlocks of the k lowest-resolution
stages (stage 0 = the mid blocks and the latent-resolution ``up`` level),
while the mid attention always replays.  The replay runs the same function,
so values are unchanged; with the flash switch on, the replayed mid
attention launches K2's forward a second time.  Forward-only decoding (no
grad) checkpoints nothing.

``compute_dtype: bfloat16`` runs the encoder's and decoder's activations in
bf16 under the UNet's precision contract (``diffusion/unet.py``; JAX
``ssl_tpu/diffusion/vae.py:7-12``): float32 parameters cast for each call,
GroupNorm in float32, the mid attention's softmax in float32 (K2's bf16
kernels at d = 512 on the card), the encoder's moments and the decoded image
cast back to float32; ``quant_conv`` and ``post_quant_conv`` stay float32.

``AutoencoderKLResi`` is StableSR's CFW ("controllable feature wrapping")
autoencoder (autoencoder.py:469; JAX ``ssl_tpu/diffusion/vae.py:172-282``):
its ``encode`` also returns the encoder's activations after the blocks of
levels 1 and 2 (before their downsample, float32 under bf16), and its
``DecoderResi`` (ldm's ``Decoder_Mix``) fuses ``enc_feas[i - 1]`` into every
level i other than the finest and the coarsest, before the upsample, through
a ``FuseSftBlockRRDB`` named ``decoder.fusion_layer_{i}``.  A fuse block's
two bracketing blocks are ldm's ``ResBlock`` (the VAE ResnetBlock's math, its
1x1 skip named ``conv_out``) and its trunk is ``encode_enc_2.{k}``, ESRGAN
RRDBs of growth 32 (``rdb{r}.conv{c}``), so a StableSR CFW state dict loads
by its own keys.  ``DecoderResi`` remats as ``Decoder`` does, its fuse
blocks too (as the JAX module does); it has no ``remat_skip_lowres``."""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ssl_tpu_torch.archs.arch_util import Conv2d
from ssl_tpu_torch.archs.rrdbnet_arch import RRDB, ResidualDenseBlock
from ssl_tpu_torch.diffusion.unet import GroupNorm, activation_dtype, init_params
from ssl_tpu_torch.ops.attention import sdp_attention


def _num_groups(c: int) -> int:
    return 32 if c % 32 == 0 else (math.gcd(c, 32) or 1)


def Normalize(c: int) -> GroupNorm:
    return GroupNorm(_num_groups(c), c, eps=1e-6)


def _conv1x1(layer: nn.Conv2d, x_tokens: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv applied to (b, hw, c) tokens as a matmul, in their type."""
    return F.linear(x_tokens, layer.weight[:, :, 0, 0].to(x_tokens.dtype),
                    layer.bias.to(x_tokens.dtype))


class ResnetBlock(nn.Module):
    #: the 1x1 skip's name where the channels change
    skip = "nin_shortcut"

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = Normalize(in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = Normalize(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            setattr(self, self.skip, Conv2d(in_channels, out_channels, 1))

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, self.skip):
            x = getattr(self, self.skip)(x)
        return x + h


class ResBlock(ResnetBlock):
    """ldm's ResBlock (model.py:797), the fuse blocks' bracketing block: the
    ResnetBlock's math with its skip named ``conv_out``."""
    skip = "conv_out"


class AttnBlock(nn.Module):
    """Single-head mid-block attention (model.py:154), width c, scale c^-1/2."""

    def __init__(self, c: int, use_flash_attention: bool = False):
        super().__init__()
        self.use_flash_attention = use_flash_attention
        self.norm = Normalize(c)
        self.q = Conv2d(c, c, 1)
        self.k = Conv2d(c, c, 1)
        self.v = Conv2d(c, c, 1)
        self.proj_out = Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x).flatten(2).transpose(1, 2)
        q, k, v = (_conv1x1(layer, y).view(b, h * w, 1, c) for layer in (self.q, self.k, self.v))
        out = sdp_attention(q, k, v, c ** -0.5, self.use_flash_attention).view(b, h * w, c)
        return x + _conv1x1(self.proj_out, out).transpose(1, 2).reshape(b, c, h, w)


class Downsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Mid(nn.Module):
    def __init__(self, c: int, use_flash_attention: bool):
        super().__init__()
        self.block_1 = ResnetBlock(c, c)
        self.attn_1 = AttnBlock(c, use_flash_attention)
        self.block_2 = ResnetBlock(c, c)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class _Level(nn.Module):
    """One resolution level: its ResnetBlocks and, where there is one, the
    resampling conv (``downsample`` in the encoder, ``upsample`` in the decoder)."""

    def __init__(self, blocks: list, resample: str | None = None, c: int = 0):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample == "down":
            self.downsample = Downsample(c)
        elif resample == "up":
            self.upsample = Upsample(c)


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, in_channels: int = 3, z_channels: int = 4,
                 double_z: bool = True, use_flash_attention: bool = False,
                 compute_dtype: str | None = None):
        super().__init__()
        self.dtype = activation_dtype(compute_dtype)
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1)
        self.down = nn.ModuleList()
        c = ch
        for i, mult in enumerate(ch_mult):
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(c, ch * mult))
                c = ch * mult
            last = i == len(ch_mult) - 1
            self.down.append(_Level(blocks, None if last else "down", c))
        self.mid = _Mid(c, use_flash_attention)
        self.norm_out = Normalize(c)
        self.conv_out = Conv2d(c, 2 * z_channels if double_z else z_channels, 3, padding=1)

    def forward(self, x, return_fea: bool = False):
        """The moments; with ``return_fea`` also the activations after the
        blocks of levels 1 and 2 (before their downsample), in float32."""
        feas = []
        h = self.conv_in(x if self.dtype is None else x.to(self.dtype))
        for i, level in enumerate(self.down):
            for blk in level.block:
                h = blk(h)
            if i in (1, 2):
                feas.append(h.float())
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        h = self.conv_out(F.silu(self.norm_out(h))).float()
        return (h, feas) if return_fea else h


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, out_ch: int = 3, z_channels: int = 4,
                 use_flash_attention: bool = False, remat_blocks: bool = True,
                 remat_skip_lowres: int = 0, compute_dtype: str | None = None):
        super().__init__()
        self.dtype = activation_dtype(compute_dtype)
        self.remat_blocks = remat_blocks
        self.remat_skip_lowres = remat_skip_lowres
        c = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, c, 3, padding=1)
        self.mid = _Mid(c, use_flash_attention)
        levels = [None] * len(ch_mult)      # up.0 is the finest level, as in ldm
        for i in reversed(range(len(ch_mult))):
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(c, ch * ch_mult[i]))
                c = ch * ch_mult[i]
            levels[i] = _Level(blocks, "up" if i != 0 else None, c)
        self.up = nn.ModuleList(levels)
        self.norm_out = Normalize(c)
        self.conv_out = Conv2d(c, out_ch, 3, padding=1)

    def forward(self, z, enc_feas=None):
        """The image of latent ``z``; ``enc_feas`` (the encoder's features)
        feed the fusion layers, which only ``DecoderResi`` has."""
        remat = self.remat_blocks and torch.is_grad_enabled()

        def run(block, h, stage=None):
            """``block(h)``, replayed in the backward when remat is on and the
            block's stage (resolution doublings above the latent) is not
            exempt; the mid attention and the fuse blocks (stage None)
            always replay."""
            if remat and (stage is None or stage >= self.remat_skip_lowres):
                return checkpoint(block, h, use_reentrant=False)
            return block(h)

        h = run(self.mid.block_1, self.conv_in(z if self.dtype is None else z.to(self.dtype)), 0)
        h = run(self.mid.block_2, run(self.mid.attn_1, h), 0)
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            for blk in level.block:
                h = run(blk, h, len(self.up) - 1 - i)
            fuse = getattr(self, f"fusion_layer_{i}", None)
            if fuse is not None:         # replayed like the mid attention
                h = run(partial(fuse, enc_feas[i - 1], w=self.fusion_w), h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h))).float()


class FuseSftBlockRRDB(nn.Module):
    """ldm's Fuse_sft_block_RRDB (model.py:822):
    ``dec + w * ResBlock(RRDB^n(ResBlock(cat(enc, dec))))``."""

    def __init__(self, c: int, num_block: int = 2, num_grow_ch: int = 32):
        super().__init__()
        self.encode_enc_1 = ResBlock(2 * c, c)
        self.encode_enc_2 = nn.Sequential(*[RRDB(c, num_grow_ch) for _ in range(num_block)])
        self.encode_enc_3 = ResBlock(c, c)

    def forward(self, enc_feat, dec_feat, w: float = 1.0):
        h = self.encode_enc_1(torch.cat([enc_feat.to(dec_feat.dtype), dec_feat], dim=1))
        return dec_feat + w * self.encode_enc_3(self.encode_enc_2(h))


class DecoderResi(Decoder):
    """ldm's Decoder_Mix (model.py:677): ``Decoder`` with a fusion layer at
    every level but the finest and the coarsest."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, out_ch: int = 3, z_channels: int = 4,
                 fusion_w: float = 1.0, num_fuse_block: int = 2,
                 use_flash_attention: bool = False, remat_blocks: bool = True,
                 compute_dtype: str | None = None):
        super().__init__(ch, ch_mult, num_res_blocks, out_ch, z_channels, use_flash_attention,
                         remat_blocks, 0, compute_dtype)
        self.fusion_w = fusion_w
        for i in range(1, len(ch_mult) - 1):
            setattr(self, f"fusion_layer_{i}", FuseSftBlockRRDB(ch * ch_mult[i], num_fuse_block))


class AutoencoderKL(nn.Module):
    """KL VAE with quant convs; ``encode`` returns (mean, logvar)."""

    def __init__(self, embed_dim: int = 4, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, use_flash_attention: bool = False,
                 remat_decoder_blocks: bool = True, remat_skip_lowres: int = 0,
                 compute_dtype: str | None = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, z_channels=embed_dim,
                               use_flash_attention=use_flash_attention,
                               compute_dtype=compute_dtype)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, z_channels=embed_dim,
                               use_flash_attention=use_flash_attention,
                               remat_blocks=remat_decoder_blocks,
                               remat_skip_lowres=remat_skip_lowres, compute_dtype=compute_dtype)
        self.quant_conv = nn.Conv2d(2 * embed_dim, 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, embed_dim, 1)

    def encode(self, x):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


class AutoencoderKLResi(nn.Module):
    """The CFW autoencoder (autoencoder.py:469): ``encode`` returns (mean,
    logvar, features) and ``decode(z, features)`` fuses them."""

    def __init__(self, embed_dim: int = 4, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, fusion_w: float = 1.0, num_fuse_block: int = 2,
                 use_flash_attention: bool = False, remat_decoder_blocks: bool = True,
                 compute_dtype: str | None = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, z_channels=embed_dim,
                               use_flash_attention=use_flash_attention,
                               compute_dtype=compute_dtype)
        self.decoder = DecoderResi(ch, ch_mult, num_res_blocks, z_channels=embed_dim,
                                   fusion_w=fusion_w, num_fuse_block=num_fuse_block,
                                   use_flash_attention=use_flash_attention,
                                   remat_blocks=remat_decoder_blocks, compute_dtype=compute_dtype)
        self.quant_conv = nn.Conv2d(2 * embed_dim, 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, embed_dim, 1)

    def encode(self, x):
        moments, feas = self.encoder(x, return_fea=True)
        mean, logvar = self.quant_conv(moments).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0), feas

    def decode(self, z, enc_feas):
        return self.decoder(self.post_quant_conv(z), enc_feas)


@torch.no_grad()
def init_cfw(net: AutoencoderKLResi, generator: torch.Generator) -> AutoencoderKLResi:
    """Seeded weights: flax's lecun-normal init (``unet.py::init_params``),
    then the fuse blocks' RRDB dense convs redrawn kaiming-normal x 0.1, as
    the JAX ``RRDB`` draws them (``scaled_kaiming_init(0.1)``)."""
    init_params(net, generator)
    for m in net.modules():
        if isinstance(m, ResidualDenseBlock):
            for conv in m.children():
                conv.weight.normal_(0.0, 1.0, generator=generator).mul_(
                    0.1 * math.sqrt(2.0 / conv.weight[0].numel()))
    return net
