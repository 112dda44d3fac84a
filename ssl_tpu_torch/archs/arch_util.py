"""Architecture building blocks (reference: basicsr/archs/arch_util.py).

Counterpart of the parts of ``ssl_tpu/archs/arch_util.py`` that RRDBNet and
the VGG-style discriminator need.  Weights are drawn from an explicit
``torch.Generator`` so a seed fixes them on every device."""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def normal_init_(module: nn.Module, generator: torch.Generator, gain: float = 1.0,
                 scale: float = 1.0) -> None:
    """Re-draw every conv / linear weight in ``module`` from
    N(0, gain / fan_in) * scale with zero biases, and reset batch norms to
    scale 1, bias 0.  gain 1 is flax's default (lecun) init, gain 2 with
    scale 0.1 the reference's residual-block ``default_init_weights``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator) * (math.sqrt(gain / fan_in) * scale)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


def make_layer(block_cls, num_blocks: int, **kwargs) -> nn.Sequential:
    """``num_blocks`` instances of ``block_cls`` applied in sequence."""
    return nn.Sequential(*[block_cls(**kwargs) for _ in range(num_blocks)])


def check_compute_dtype(compute_dtype) -> None:
    if compute_dtype is not None:
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r}: the bf16 activation knobs are not ported "
            "(queued in ROADMAP.md); the port computes in float32")
