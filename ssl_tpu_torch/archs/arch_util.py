"""Architecture building blocks (reference: basicsr/archs/arch_util.py).

Counterpart of the parts of ``ssl_tpu/archs/arch_util.py`` that the ported
archs need, and the bottom-right pads of inference (reflect) and of SwinIR
and ELAN (``np.pad``'s "symmetric" and "reflect").  Weights are drawn from
an explicit ``torch.Generator`` so a seed fixes them on every device."""

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


def _reflect_index(n: int, total: int, device) -> torch.Tensor:
    """Source rows of an axis of n reflect-padded at its end to ``total``,
    as ``np.pad(mode="reflect")`` pads (also past n - 1)."""
    i = torch.arange(total, device=device)
    if n == 1:
        return torch.zeros_like(i)
    i = i % (2 * (n - 1))
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def pad_reflect(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Reflect-pad an NCHW tensor by ``ph`` rows at the bottom and ``pw``
    columns at the right."""
    h, w = x.shape[-2:]
    return (x.index_select(-2, _reflect_index(h, h + ph, x.device))
             .index_select(-1, _reflect_index(w, w + pw, x.device)))


def _symmetric_index(n: int, total: int, device) -> torch.Tensor:
    """Source rows of an axis of n padded at its end to ``total`` by
    ``np.pad(mode="symmetric")``: the edge repeated, then mirrored, with
    period 2n (a pad as long as the axis itself reads it backwards)."""
    i = torch.arange(total, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def pad_symmetric(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """``pad_reflect`` with the edge repeated (``np.pad(mode="symmetric")``)."""
    h, w = x.shape[-2:]
    return (x.index_select(-2, _symmetric_index(h, h + ph, x.device))
             .index_select(-1, _symmetric_index(w, w + pw, x.device)))


def make_layer(block_cls, num_blocks: int, **kwargs) -> nn.Sequential:
    """``num_blocks`` instances of ``block_cls`` applied in sequence."""
    return nn.Sequential(*[block_cls(**kwargs) for _ in range(num_blocks)])


def compute_dtype_of(compute_dtype):
    """The torch dtype of the JAX archs' ``compute_dtype`` knob (flax's
    ``dtype=``): None for float32 throughout, else ``torch.bfloat16``."""
    if compute_dtype in (None, "float32"):
        return None
    if compute_dtype == "bfloat16":
        return torch.bfloat16
    raise NotImplementedError(f"compute_dtype={compute_dtype!r}: the port takes float32 or "
                              "bfloat16")


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype, as flax's ``nn.Conv``
    with ``dtype=`` does: the float32 parameters are cast for each call (a
    float32 input leaves them as they are)."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  None if self.bias is None else self.bias.to(x.dtype))
