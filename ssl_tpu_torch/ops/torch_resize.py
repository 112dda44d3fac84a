"""Resizes of the on-device degradation.

Counterpart of ``ssl_tpu/ops/torch_resize.py::interp_torch``: the JAX
package emulates ``F.interpolate`` (area = adaptive average pooling,
bilinear and bicubic with ``align_corners=False`` and no antialias) with
band matrices; here it is ``F.interpolate`` itself.  The numpy
``torch_resize_np`` and BebyGAN's ``bebygan_imresize_down`` wait for their
recipes (ROADMAP.md)."""

from __future__ import annotations

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
