"""Loss helpers: weighted reduction and LDL's artifact map (reference
basicsr/losses/loss_util.py:13-161).

Counterpart of ``ssl_tpu/losses/loss_util.py``; tensors are NCHW, so the
channel axis is 1."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def _local_variance(residual: torch.Tensor, ksize: int) -> torch.Tensor:
    """Unbiased variance over the ksize x ksize reflect-padded window of each
    pixel of a (b, 1, h, w) map (reference get_local_weights :106-127)."""
    pad = (ksize - 1) // 2
    b, _, h, w = residual.shape
    cols = F.unfold(F.pad(residual, (pad, pad, pad, pad), mode="reflect"), ksize)
    mean = cols.mean(dim=1, keepdim=True)
    var = torch.sum((cols - mean) ** 2, dim=1) / (ksize * ksize - 1)
    return var.reshape(b, 1, h, w)


def get_refined_artifact_map(img_gt, img_output, img_ema, ksize=7):
    """LDL's artifact map (reference :135-161): the output's per-pixel L1
    residual's local variance, scaled by the image's residual variance to
    the power 0.2, and 0 where the output is closer to GT than the EMA's."""
    residual_ema = torch.sum(torch.abs(img_gt - img_ema), dim=1, keepdim=True)
    residual_sr = torch.sum(torch.abs(img_gt - img_output), dim=1, keepdim=True)
    patch_level = torch.var(residual_sr, dim=(1, 2, 3), keepdim=True, unbiased=True) ** 0.2
    overall = patch_level * _local_variance(residual_sr, ksize)
    return torch.where(residual_sr < residual_ema, torch.zeros_like(overall), overall)
