"""Output color correction: AdaIN and wavelet color fix.

Counterpart of ``ssl_tpu/diffusion/color_fix.py`` (the reference
Diffusion-Based-SR/scripts/wavelet_color_fix.py), on (b, c, h, w) tensors in
[0, 1] on any device.  Like the JAX package it computes in float64 and
returns float32.  The à-trous blur, ``cv2.filter2D`` with a dilated 5-tap
binomial kernel and replicated borders there, is a depthwise dilated
``conv2d`` on a replicate-padded image here, so no ``cv2`` is needed."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adain_color_fix(target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Match target's per-channel mean and std to source's."""
    t, s = target.double(), source.double()
    t_mean, t_std = t.mean(dim=(-2, -1), keepdim=True), t.std(dim=(-2, -1), keepdim=True,
                                                             unbiased=False) + 1e-8
    s_mean, s_std = s.mean(dim=(-2, -1), keepdim=True), s.std(dim=(-2, -1), keepdim=True,
                                                             unbiased=False) + 1e-8
    return ((t - t_mean) / t_std * s_std + s_mean).clamp(0, 1).float()


def _wavelet_blur(img: torch.Tensor, radius: int) -> torch.Tensor:
    """A-trous blur: the 5x5 binomial kernel with holes of size ``radius``."""
    c = img.shape[1]
    k1 = torch.tensor([1, 4, 6, 4, 1], dtype=img.dtype, device=img.device) / 16.0
    kernel = torch.outer(k1, k1).expand(c, 1, 5, 5)
    p = 2 * radius
    return F.conv2d(F.pad(img, (p, p, p, p), mode="replicate"), kernel, dilation=radius, groups=c)


def wavelet_decomposition(img: torch.Tensor, levels: int = 5):
    """Split into the high-frequency detail and the low-frequency residual."""
    high = torch.zeros_like(img)
    low = img
    for i in range(levels):
        blurred = _wavelet_blur(low, 2 ** i)
        high = high + (low - blurred)
        low = blurred
    return high, low


def wavelet_color_fix(target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Keep target's high-frequency detail, take source's low-frequency color."""
    t_high, _ = wavelet_decomposition(target.double())
    _, s_low = wavelet_decomposition(source.double())
    return (t_high + s_low).clamp(0, 1).float()
