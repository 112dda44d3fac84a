"""Resizes of the on-device degradation and of BebyGAN's losses.

Counterpart of ``ssl_tpu/ops/torch_resize.py``: the JAX package emulates
``F.interpolate`` (area = adaptive average pooling, bilinear and bicubic
with ``align_corners=False`` and no antialias) with band matrices
(``interp_torch``, ``interp_bicubic``); here it is ``F.interpolate`` itself.
``bebygan_imresize_down`` is the reference BebyGAN's own differentiable
``imresize`` on its integer-downscale path.  The numpy ``torch_resize_np``
waits for its recipes (ROADMAP.md)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

MODES = ("area", "bilinear", "bicubic")


def interp_torch(x: torch.Tensor, size: tuple[int, int], mode: str) -> torch.Tensor:
    """``F.interpolate(x, size, mode)`` of an NCHW batch; the input itself
    when the size is unchanged (as the JAX band matrices skip it)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    if mode == "area":
        return F.interpolate(x, size=tuple(size), mode="area")
    return F.interpolate(x, size=tuple(size), mode=mode, align_corners=False, antialias=False)


def interp_bicubic(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``F.interpolate(x, size, mode="bicubic", align_corners=False)`` without
    antialias (BebyGAN's GT pyramid, reference bebyganssl_model.py:552-560)."""
    return interp_torch(x, size, "bicubic")


@lru_cache(maxsize=None)
def _discrete_cubic_kernel_np(factor: int) -> np.ndarray:
    """The reference's ``discrete_kernel('cubic', 1 / factor,
    antialiasing=True)`` (bebyganssl_model.py:133-163): a separable cubic
    (a = -0.5) sampled on a symmetric grid of 4 factor points (one fewer for
    odd factors), normalized; returns the 2-d kernel."""
    ks = 4 * factor
    if factor % 2 == 0:
        a_ext = 4 * (0.5 - 1.0 / (2 * ks))
    else:
        ks -= 1
        a_ext = 4 * (0.5 - 1.0 / (ks + 1))
    ax = np.abs(np.linspace(-a_ext, a_ext, ks))
    a = -0.5
    near = (((a + 2) * ax - (a + 3)) * ax * ax + 1) * (ax <= 1)
    far = ((((a * ax - 5 * a) * ax + 8 * a) * ax) - 4 * a) * ((ax > 1) & (ax <= 2))
    k = near + far
    k = k / k.sum()
    k2d = np.outer(k, k)
    return k2d / k2d.sum()


def _reflect_pad_matlab(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """MATLAB-style reflection that repeats the edge, along ``dim``:
    [a, b, c, d] -> [b, a, a, b, c, d, d, c] for pad 2 (the reference's
    ``reflect_padding``, bebyganssl_model.py:164-196)."""
    if pad == 0:
        return x
    n = x.shape[dim]
    idx = torch.cat([torch.arange(pad - 1, -1, -1), torch.arange(n),
                     torch.arange(n - 1, n - 1 - pad, -1)]).to(x.device)
    return x.index_select(dim, idx)


def bebygan_imresize_down(x: torch.Tensor, factor: int) -> torch.Tensor:
    """The reference's ``imresize(x, scale=1 / factor)`` for an integer
    factor (bebyganssl_model.py:375-468, the only way the recipe calls it):
    the discrete antialiased cubic kernel, MATLAB reflection and a
    depthwise convolution of stride ``factor``.  NCHW."""
    k2d = torch.as_tensor(_discrete_cubic_kernel_np(factor), dtype=x.dtype, device=x.device)
    pad = (k2d.shape[0] - factor) // 2
    xp = _reflect_pad_matlab(_reflect_pad_matlab(x, pad, -2), pad, -1)
    c = x.shape[1]
    return F.conv2d(xp, k2d.expand(c, 1, *k2d.shape), stride=factor, groups=c)
