"""CLIP RN50 — the image and text towers of CLIP-IQA.

Counterpart of ``ssl_tpu/archs/clip_arch.py`` (reference: the GAN tree's
vendored scripts/metrics/clip/model.py and clipiqa_pyiqa/clip_model.py):
the ModifiedResNet visual tower (3-conv stem with an average pool,
bottlenecks whose stride is an average pool before the last 1x1, attention
pooling) and the pre-LN causal text transformer, NCHW.  The modules carry
OpenAI CLIP's names, so an RN50 state dict loads as it is: ``visual.*``
into ``ModifiedResNet``, the rest into ``CLIPTextEncoder``.  The ViT visual
tower waits for the rest of the diffusion tree (ROADMAP.md)."""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> (avg pool if stride) -> 1x1, each with batch norm; the
    shortcut is avg pool + 1x1 conv + batch norm where the shape changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = None
        if stride > 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride) if stride > 1 else nn.Identity()),
                ("0", nn.Conv2d(inplanes, planes * 4, 1, bias=False)),
                ("1", nn.BatchNorm2d(planes * 4))]))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(self.avgpool(out)))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class AttentionPool2d(nn.Module):
    """Attention pooling with the mean token as the only query, in CLIP-IQA's
    mode (clipiqa_arch.py:101, ``pos_embedding=False``): no positional
    embedding is added, so any input size works.  ``positional_embedding``
    stays a parameter so that an RN50 state dict loads as it is."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.randn(spacial_dim ** 2 + 1, embed_dim) / embed_dim ** 0.5)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)
        self.num_heads = num_heads

    def forward(self, x):
        b, c = x.shape[:2]
        seq = x.flatten(2).transpose(1, 2)                      # (b, hw, c)
        seq = torch.cat([seq.mean(dim=1, keepdim=True), seq], dim=1)
        nh, hd = self.num_heads, c // self.num_heads
        q = self.q_proj(seq[:, :1]).view(b, 1, nh, hd).transpose(1, 2)
        k = self.k_proj(seq).view(b, -1, nh, hd).transpose(1, 2)
        v = self.v_proj(seq).view(b, -1, nh, hd).transpose(1, 2)
        attn = torch.softmax((q * hd ** -0.5) @ k.transpose(-1, -2), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, c)
        return self.c_proj(out)


class ModifiedResNet(nn.Module):
    """CLIP RN50's visual tower (width 64, layers (3, 4, 6, 3), embed 1024)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), output_dim: int = 1024,
                 heads: int = 32, width: int = 64, attn_spacial_dim: int = 7):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(width // 2)
        self.conv2 = nn.Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width // 2)
        self.conv3 = nn.Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = nn.BatchNorm2d(width)
        inplanes = width
        for i, blocks in enumerate(layers):
            planes = width * 2 ** i
            stage = []
            for j in range(blocks):
                stage.append(Bottleneck(inplanes, planes, 2 if (j == 0 and i > 0) else 1))
                inplanes = planes * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*stage))
        self.n_layers = len(layers)
        self.attnpool = AttentionPool2d(attn_spacial_dim, width * 32, heads, output_dim)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.avg_pool2d(F.relu(self.bn3(self.conv3(x))), 2)
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i + 1}")(x)
        return self.attnpool(x)


class _Attention(nn.Module):
    """Multi-head self-attention in ``nn.MultiheadAttention``'s layout:
    ``in_proj_weight`` (3C, C) holds q, k and v, ``out_proj`` a Linear."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        self.heads = heads
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, mask):
        b, n, c = x.shape
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        hd = c // self.heads

        def split(t):
            return t.view(b, n, self.heads, hd).transpose(1, 2)

        attn = torch.softmax((split(q) * hd ** -0.5) @ split(k).transpose(-1, -2) + mask, dim=-1)
        return self.out_proj((attn @ split(v)).transpose(1, 2).reshape(b, n, c))


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, width * 4)
        self.c_proj = nn.Linear(width * 4, width)

    def forward(self, x):
        y = self.c_fc(x)
        return self.c_proj(y * torch.sigmoid(1.702 * y))        # QuickGELU (OpenAI CLIP)


class _TextBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = _Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = _MLP(width)

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(_TextBlock(width, heads) for _ in range(layers))


class CLIPTextEncoder(nn.Module):
    """CLIP's text tower: token ids (b, n) -> (b, embed_dim), pooled at the
    end-of-text token (the largest id in each row)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 layers: int = 12, heads: int = 8, embed_dim: int = 1024):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.randn(context_length, width) * 0.01)
        self.transformer = _Transformer(width, layers, heads)
        self.ln_final = nn.LayerNorm(width)
        self.text_projection = nn.Parameter(torch.randn(width, embed_dim) / width ** 0.5)

    def forward(self, token_ids):
        x = self.token_embedding(token_ids)
        n = x.shape[1]
        mask = torch.full((n, n), float("-inf"), device=x.device, dtype=x.dtype).triu(1)
        x = x + self.positional_embedding[:n]
        for blk in self.transformer.resblocks:
            x = blk(x, mask)
        x = self.ln_final(x)
        eot = token_ids.argmax(dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot] @ self.text_projection
