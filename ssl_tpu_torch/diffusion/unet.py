"""Diffusion UNet with dual conditioning: StableSR's UNetModelDualcondV2 and
its time-aware struct-cond encoder EncoderUNetModelWT.

Counterpart of ``ssl_tpu/diffusion/unet.py``, in NCHW.  Module paths are
StableSR's torch names (``input_blocks.3.0.in_layers.2``,
``middle_block.1.proj_in``, ``fea_tran.0``, ...), which the flax module names
encode with underscores, so ``utils/weight_port.py`` carries a flax tree over
key by key and StableSR checkpoints keep their keys.  The configuration is
the one StableSR ships and the JAX package implements:
use_scale_shift_norm False, use_linear_in_transformer True, conv_resample
True, dropout 0.  GroupNorm has 32 groups and eps 1e-5, LayerNorm eps 1e-5,
GELU is exact.  Self-attention goes through ``ops/attention.py::
sdp_attention``: with ``use_flash_attention`` on, eligible calls on CUDA
launch the flash kernel K2.

``compute_dtype: bfloat16`` runs the conv, linear and attention activations
in bf16, the JAX package's precision contract (``ssl_tpu/diffusion/unet.py``
:24-31): the parameters stay float32 and are cast for each call (``Conv2d``,
``Linear``), GroupNorm and LayerNorm compute their statistics and their
normalisation in float32 and return bf16 (``GroupNorm``, ``LayerNorm``: what
flax's norms with ``dtype=bf16`` do), the attention softmax runs in float32
(``ops/attention.py``; K2's bf16 kernels on the card), and the outputs (the
UNet's eps, each struct-cond feature) are cast back to float32.  The
networks cast their inputs, time embedding, context and struct features to
bf16 where flax's first bf16 layer would.  Other types raise."""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ssl_tpu_torch.archs.arch_util import Conv2d
from ssl_tpu_torch.ops.attention import sdp_attention
from ssl_tpu_torch.parallel.tensor import copy_to_tp, reduce_from_tp

NOT_PORTED = "is not ported yet (ROADMAP.md, queue 1)"


def activation_dtype(compute_dtype):
    """The activations' type under the diffusion nets' ``compute_dtype``
    (flax's ``dtype=``): None for float32 throughout, or ``torch.bfloat16``."""
    if compute_dtype in (None, "float32"):
        return None
    if compute_dtype == "bfloat16":
        return torch.bfloat16
    raise NotImplementedError(f"compute_dtype={compute_dtype!r} {NOT_PORTED}: the diffusion "
                              "nets take float32 or bfloat16")


class Linear(nn.Linear):
    """``nn.Linear`` in its input's type: the float32 parameters are cast for
    each call, as flax's ``nn.Dense`` with ``dtype=`` does."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` computed in float32 and returned in its input's type,
    as flax's ``nn.GroupNorm`` with ``dtype=`` (float32 statistics, the
    normalisation and affine in float32, one rounding at the end)."""

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in float32 and returned in its input's type
    (flax's ``nn.LayerNorm`` with ``dtype=``)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding, cos before sin (ssl_tpu/diffusion/unet.py:47)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                            device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def normalization(ch: int) -> GroupNorm:
    """GroupNorm32 (openaimodel normalization()): 32 groups, eps 1e-5."""
    return GroupNorm(32, ch, eps=1e-5)


def zero_module(m: nn.Module) -> nn.Module:
    """Mark a layer that the JAX package initialises to zero (its output conv
    or projection); ``init_params`` zeroes it."""
    m.zero_init = True
    return m


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init in flax's style: conv and linear weights lecun-normal
    (std 1 / sqrt(fan_in)), biases 0, norms 1 and 0, and every layer marked by
    ``zero_module`` all 0, as the JAX package leaves them."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0, generator=generator).mul_(fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
            if getattr(m, "zero_init", False):
                m.weight.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module


class SPADE(nn.Module):
    """spade.py:68 with nhidden 128: the struct feature of the matching width
    modulates the group-normalised h."""

    def __init__(self, norm_nc: int, label_nc: int, nhidden: int = 128):
        super().__init__()
        self.param_free_norm = normalization(norm_nc)
        self.mlp_shared = nn.Sequential(Conv2d(label_nc, nhidden, 3, padding=1), nn.ReLU())
        self.mlp_gamma = Conv2d(nhidden, norm_nc, 3, padding=1)
        self.mlp_beta = Conv2d(nhidden, norm_nc, 3, padding=1)

    def forward(self, x, s_dict):
        actv = self.mlp_shared(s_dict[str(x.shape[-1])])
        return self.param_free_norm(x) * (1 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class ResBlockRef(nn.Module):
    """openaimodel ResBlock (use_scale_shift_norm False, dropout 0):
    h = zero_conv(silu(GN(conv(silu(GN(x))) + emb_proj))); skip(x) + h."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int):
        super().__init__()
        self.in_layers = nn.Sequential(normalization(channels), nn.SiLU(),
                                       Conv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_channels, out_channels))
        self.out_layers = nn.Sequential(
            normalization(out_channels), nn.SiLU(), nn.Dropout(0.0),
            zero_module(Conv2d(out_channels, out_channels, 3, padding=1)))
        self.skip_connection = (nn.Identity() if channels == out_channels
                                else Conv2d(channels, out_channels, 1))

    def residual(self, x, emb):
        h = self.in_layers(x) + self.emb_layers(emb)[:, :, None, None]
        return self.out_layers(h)

    def forward(self, x, emb):
        return self.skip_connection(x) + self.residual(x, emb)


class ResBlockDual(ResBlockRef):
    """ResBlockDual (openaimodel.py:343): the ResBlock with SPADE struct-cond
    modulation before the residual add."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int, semb_channels: int):
        super().__init__(channels, emb_channels, out_channels)
        self.spade = SPADE(out_channels, semb_channels)

    def forward(self, x, emb, s_dict):
        return self.skip_connection(x) + self.spade(self.residual(x, emb), s_dict)


class Downsample(nn.Module):
    """conv_resample downsample: conv 3x3, stride 2, padding 1."""

    def __init__(self, ch: int):
        super().__init__()
        self.op = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    """Nearest x2, then conv 3x3."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class CrossAttention(nn.Module):
    """attention.py CrossAttention: self-attention without a context, else
    cross-attention over it; softmax(q kᵀ / sqrt(d)) v per head."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int,
                 use_flash_attention: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.use_flash_attention = use_flash_attention
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, query_dim), nn.Dropout(0.0))

    def forward(self, x, context=None):
        b, n, _ = x.shape
        ctx = x if context is None else context
        q = self.to_q(x).view(b, n, self.heads, self.dim_head)
        k = self.to_k(ctx).view(b, -1, self.heads, self.dim_head)
        v = self.to_v(ctx).view(b, -1, self.heads, self.dim_head)
        out = sdp_attention(q, k, v, self.dim_head ** -0.5, self.use_flash_attention)
        return self.to_out(out.reshape(b, n, self.heads * self.dim_head))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0), Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 use_flash_attention: bool = False):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dim_head, use_flash_attention)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, use_flash_attention)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.norm3 = LayerNorm(dim, eps=1e-5)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformerV2(nn.Module):
    """attention.py:350 with use_linear (the SD 2.1 / StableSR layout): GN ->
    tokens -> proj_in -> depth x BasicTransformerBlock -> proj_out -> + x."""

    def __init__(self, in_channels: int, heads: int, dim_head: int, depth: int,
                 context_dim: int, use_flash_attention: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.norm = normalization(in_channels)
        self.proj_in = Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, context_dim, use_flash_attention)
            for _ in range(depth))
        self.proj_out = zero_module(Linear(inner, in_channels))

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        for blk in self.transformer_blocks:
            y = blk(y, context)
        return x + self.proj_out(y).transpose(1, 2).reshape(b, c, h, w)


class AttentionBlockQKV(nn.Module):
    """openaimodel AttentionBlock (:463) with QKVAttentionLegacy packing: the
    qkv channels are head-major blocks [q_h | k_h | v_h], and q and k are
    each scaled by d^-1/4 (so sm_scale is 1).  qkv and proj_out are kernel-1
    Conv1d layers, as in StableSR, applied as matmuls on the tokens."""

    def __init__(self, channels: int, num_heads: int, use_flash_attention: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.use_flash_attention = use_flash_attention
        self.norm = normalization(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = zero_module(nn.Conv1d(channels, channels, 1))
        # tensor parallelism (parallel/tensor.py): this rank holds num_heads / tp
        # heads of qkv's output and proj_out's input
        self.tp, self.tp_group = 1, None

    def forward(self, x):
        b, c, h, w = x.shape
        d = c // self.num_heads
        heads = self.num_heads // self.tp
        y = self.norm(x).flatten(2).transpose(1, 2)
        if self.tp_group is not None:
            y = copy_to_tp(y, self.tp_group)
        qkv = F.linear(y, self.qkv.weight[:, :, 0].to(y.dtype), self.qkv.bias.to(y.dtype))
        qkv = qkv.view(b, h * w, heads, 3, d)
        scale = 1.0 / math.sqrt(math.sqrt(d))
        out = sdp_attention(qkv[..., 0, :] * scale, qkv[..., 1, :] * scale, qkv[..., 2, :], 1.0,
                            self.use_flash_attention).reshape(b, h * w, heads * d)
        if self.tp_group is None:
            out = F.linear(out, self.proj_out.weight[:, :, 0].to(out.dtype),
                           self.proj_out.bias.to(out.dtype))
        else:
            out = reduce_from_tp(F.linear(out, self.proj_out.weight[:, :, 0].to(out.dtype)),
                                 self.tp_group) + self.proj_out.bias.to(out.dtype)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


def _run_block(block: nn.ModuleList, h, emb, context=None, s_dict=None):
    """One TimestepEmbedSequential: each layer gets what it takes."""
    for layer in block:
        if isinstance(layer, ResBlockDual):
            h = layer(h, emb, s_dict)
        elif isinstance(layer, ResBlockRef):
            h = layer(h, emb)
        elif isinstance(layer, SpatialTransformerV2):
            h = layer(h, context)
        else:
            h = layer(h)
    return h


class UNetModelDualcondV2(nn.Module):
    """Denoiser eps(x_t, t, context, struct_cond_dict), StableSR dual-cond."""

    def __init__(self, in_channels: int = 4, out_channels: int = 4, model_channels: int = 320,
                 num_res_blocks: int = 2, attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4), num_heads: int = -1,
                 num_head_channels: int = 64, transformer_depth: int = 1,
                 context_dim: int = 1024, semb_channels: int = 256,
                 use_flash_attention: bool = False, compute_dtype: str | None = None):
        super().__init__()
        self.dtype = activation_dtype(compute_dtype)
        mc, temb = model_channels, model_channels * 4

        def heads(ch):   # num_head_channels wins over num_heads (unet.py:239-242)
            return (ch // num_head_channels, num_head_channels) if num_head_channels > 0 \
                else (num_heads, ch // num_heads)

        def transformer(ch):
            return SpatialTransformerV2(ch, *heads(ch), transformer_depth, context_dim,
                                        use_flash_attention)

        self.model_channels = mc
        self.time_embed = nn.Sequential(Linear(mc, temb), nn.SiLU(), Linear(temb, temb))
        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv2d(in_channels, mc, 3, padding=1)])])
        chans, ch, ds = [mc], mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlockDual(ch, temb, mult * mc, semb_channels)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(transformer(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([ResBlockDual(ch, temb, ch, semb_channels),
                                           transformer(ch),
                                           ResBlockDual(ch, temb, ch, semb_channels)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [ResBlockDual(ch + chans.pop(), temb, mc * mult, semb_channels)]
                ch = mc * mult
                if ds in attention_resolutions:
                    layers.append(transformer(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(normalization(ch), nn.SiLU(),
                                 zero_module(Conv2d(ch, out_channels, 3, padding=1)))

    def forward(self, x, t, context, struct_feats=None):
        emb_in = timestep_embedding(t, self.model_channels)
        if self.dtype is not None:        # where flax's first bf16 layer casts them
            x, emb_in, context = x.to(self.dtype), emb_in.to(self.dtype), context.to(self.dtype)
            if struct_feats is not None:
                struct_feats = {k: f.to(self.dtype) for k, f in struct_feats.items()}
        emb = self.time_embed(emb_in)
        hs, h = [], x
        for block in self.input_blocks:
            h = _run_block(block, h, emb, context, struct_feats)
            hs.append(h)
        h = _run_block(self.middle_block, h, emb, context, struct_feats)
        for block in self.output_blocks:
            h = _run_block(block, torch.cat([h, hs.pop()], dim=1), emb, context, struct_feats)
        out = self.out(h)
        return out if self.dtype is None else out.float()


class EncoderUNetModelWT(nn.Module):
    """Time-aware struct-cond encoder (openaimodel.py:1341): a half UNet whose
    features entering each downsample, and the middle output, pass through
    per-resolution ``fea_tran`` ResBlocks; returns {str(width): feature}."""

    def __init__(self, in_channels: int = 4, model_channels: int = 256, out_channels: int = 256,
                 num_res_blocks: int = 2, attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 1, 2, 2), num_heads: int = 4,
                 use_flash_attention: bool = False, compute_dtype: str | None = None):
        super().__init__()
        self.dtype = activation_dtype(compute_dtype)
        mc, temb = model_channels, model_channels * 4
        self.model_channels = mc
        self.time_embed = nn.Sequential(Linear(mc, temb), nn.SiLU(), Linear(temb, temb))
        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv2d(in_channels, mc, 3, padding=1)])])
        self.feature_blocks = []          # input-block indices whose output is a feature
        result_chans, ch, ds = [], mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlockRef(ch, temb, mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(AttentionBlockQKV(ch, num_heads, use_flash_attention))
                self.input_blocks.append(nn.ModuleList(layers))
            if level != len(channel_mult) - 1:
                self.feature_blocks.append(len(self.input_blocks) - 1)
                result_chans.append(ch)
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                ds *= 2
        self.middle_block = nn.ModuleList([ResBlockRef(ch, temb, ch),
                                           AttentionBlockQKV(ch, num_heads, use_flash_attention),
                                           ResBlockRef(ch, temb, ch)])
        result_chans.append(ch)
        self.fea_tran = nn.ModuleList(ResBlockRef(c, temb, out_channels) for c in result_chans)

    def forward(self, x, t):
        emb_in = timestep_embedding(t, self.model_channels)
        if self.dtype is not None:
            x, emb_in = x.to(self.dtype), emb_in.to(self.dtype)
        emb = self.time_embed(emb_in)
        results, h = [], x
        for i, block in enumerate(self.input_blocks):
            h = _run_block(block, h, emb)
            if i in self.feature_blocks:
                results.append(h)
        results.append(_run_block(self.middle_block, h, emb))
        return {str(r.shape[-1]): tran(r, emb).float() for r, tran in zip(results, self.fea_tran)}
