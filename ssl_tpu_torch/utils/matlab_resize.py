"""MATLAB-faithful imresize (reference: utils/matlab_functions.py:86-183).

A copy of ``ssl_tpu/utils/matlab_resize.py``: the BSRGAN degradation's x2
pre-downsample and the blind-SR dataset's test-phase pairing use it, so
degraded pairs match the reference datasets bit for bit.  Antialiased
cubic kernel (a=-0.5), symmetric boundary handling, separable two-pass
resampling.  Pure numpy (host-side data prep)."""

from __future__ import annotations

import numpy as np


def _cubic(x: np.ndarray) -> np.ndarray:
    absx = np.abs(x)
    absx2, absx3 = absx ** 2, absx ** 3
    f = ((1.5 * absx3 - 2.5 * absx2 + 1) * (absx <= 1) +
         (-0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2) * ((absx > 1) & (absx <= 2)))
    return f


def _contributions(in_length: int, out_length: int, scale: float, kernel_width: float):
    if scale < 1:  # antialiasing when shrinking
        kernel_width = kernel_width / scale
    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p)[None, :] - 1
    dist = u[:, None] - indices - 1
    if scale < 1:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)
    # symmetric (mirror) boundary indices
    aux = np.concatenate([np.arange(in_length), np.arange(in_length - 1, -1, -1)])
    indices = aux[np.mod(indices.astype(np.int64), aux.size)]
    # trim zero-weight columns
    nz = np.nonzero(np.any(weights != 0, axis=0))[0]
    return weights[:, nz], indices[:, nz]


def imresize(img: np.ndarray, scale: float, antialiasing: bool = True) -> np.ndarray:
    """MATLAB imresize, bicubic, HWC or HW float/uint8.  Output dtype float64
    in input's value scale (caller rounds for uint8 parity)."""
    squeeze = False
    if img.ndim == 2:
        img = img[..., None]
        squeeze = True
    in_h, in_w, c = img.shape
    out_h = int(np.ceil(in_h * scale))
    out_w = int(np.ceil(in_w * scale))
    kernel_width = 4.0

    img64 = img.astype(np.float64)
    wh, ih = _contributions(in_h, out_h, scale, kernel_width if antialiasing else 4.0)
    ww, iw = _contributions(in_w, out_w, scale, kernel_width if antialiasing else 4.0)

    # rows pass: out1[i, x, ch] = sum_k wh[i,k] * img[ih[i,k], x, ch]
    out1 = np.einsum("ik,ikxc->ixc", wh, img64[ih, :, :])
    # cols pass
    out2 = np.einsum("jk,ijkc->ijc", ww, out1[:, iw, :])
    return out2[..., 0] if squeeze else out2


def imresize_uint8(img_uint8: np.ndarray, scale: float) -> np.ndarray:
    out = imresize(img_uint8.astype(np.float64), scale)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)
