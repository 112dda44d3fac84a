"""On-device image processing: per-item kernel filtering and USM sharpening.

Counterpart of ``ssl_tpu/ops/img_process.py`` (reference
utils/img_process_util.py: filter2D :7-31, usm_sharp :34-84) on NCHW
tensors: each item's kernel filters all of its channels, as one grouped
``conv2d`` (groups = b * c) over the reflect-padded batch."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ssl_tpu_torch.ops.ssg import reflect_index


def filter2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """img (b, c, h, w), kernel (b, k, k) with k odd: item i filtered by
    kernel i (a cross-correlation, as ``lax.conv_general_dilated``) after a
    reflect pad of k // 2 (``reflect_index``: also where k // 2 >= h, as the
    final sinc's 10 on an 8^2 LQ, which ``F.pad`` refuses)."""
    b, c, h, w = img.shape
    k = kernel.shape[-1]
    pad = k // 2
    x = (img.index_select(2, reflect_index(h, pad, img.device))
         .index_select(3, reflect_index(w, pad, img.device))
         .reshape(1, b * c, h + 2 * pad, w + 2 * pad))
    weight = kernel.to(img.dtype)[:, None].expand(b, c, k, k).reshape(b * c, 1, k, k)
    return F.conv2d(x, weight, groups=b * c).reshape(b, c, h, w)


def _gaussian_kernel1d(radius: int, device=None) -> torch.Tensor:
    """cv2.GaussianBlur's kernel for ksize 2 (radius // 2) + 1 with its
    default sigma 0.3 ((k - 1) / 2 - 1) + 0.8, in float32 as the JAX package
    computes it."""
    k = 2 * (radius // 2) + 1
    sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
    ax = (torch.arange(k, device=device) - k // 2) ** 2
    g = torch.exp(-ax.to(torch.float32) / (2 * sigma ** 2))
    return g / g.sum()


def usm_sharp(img: torch.Tensor, weight: float = 0.5, radius: int = 50,
              threshold: int = 10) -> torch.Tensor:
    """Unsharp masking of an NCHW batch in [0, 1] (reference usm_sharp)."""
    if radius % 2 == 0:
        radius += 1
    g1 = _gaussian_kernel1d(radius, img.device)
    k2 = torch.outer(g1, g1).expand(img.shape[0], -1, -1)
    blur = filter2d(img, k2)
    residual = img - blur
    mask = (residual.abs() * 255 > threshold).to(img.dtype)
    soft_mask = filter2d(mask, k2)
    sharp = torch.clamp(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img
