"""Loss helpers: weighted reduction (reference basicsr/losses/loss_util.py:13-62).

Counterpart of ``ssl_tpu/losses/loss_util.py``; tensors are NCHW, so the
channel axis is 1."""

from __future__ import annotations

import torch


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return loss
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    raise ValueError(f"invalid reduction: {reduction}")


def weight_reduce_loss(loss, weight=None, reduction="mean"):
    """Element-wise weighting then reduce; 'mean' divides by the weight mass."""
    if weight is not None:
        loss = loss * weight
    if weight is None or reduction == "sum":
        return reduce_loss(loss, reduction)
    if reduction == "mean":
        if weight.shape[1] > 1:
            wsum = torch.sum(weight)
        else:
            wsum = torch.sum(weight) * loss.shape[1]
        return torch.sum(loss) / (wsum + 1e-12)
    return loss
