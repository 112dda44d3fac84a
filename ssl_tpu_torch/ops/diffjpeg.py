"""Differentiable JPEG on NCHW tensors (reference: utils/diffjpeg.py:49-491).

Counterpart of ``ssl_tpu/ops/diffjpeg.py::diff_jpeg``: pad to a multiple of
16, RGB -> YCbCr, 2x2 average of the chroma planes, the 8x8 block DCT as two
small matmuls, quantization by the raw ``table * factor`` with the rounding
surrogate ``r + (x - r)^3``, then the inverse path and the crop.  Float32
matmuls run in full precision unless the caller turns TF32 on.

The quantization tables are the standard Annex-K luminance/chrominance
matrices of the JPEG specification (public constants)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

# ITU-T T.81 Annex K base tables; the Y table is stored transposed, as the
# reference DiffJPEG keeps it (`y_table.T`, diffjpeg.py:18-24).
Y_TABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float32).T

C_TABLE = np.full((8, 8), 99, np.float32)
C_TABLE[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]

_RGB2YCBCR = np.array([
    [0.299, 0.587, 0.114],
    [-0.168736, -0.331264, 0.5],
    [0.5, -0.418688, -0.081312]], np.float32).T
_YCBCR_SHIFT = np.array([0.0, 128.0, 128.0], np.float32)
_YCBCR2RGB = np.array([
    [1.0, 0.0, 1.402],
    [1.0, -0.344136, -0.714136],
    [1.0, 1.772, 0.0]], np.float32).T


def _dct_matrix() -> np.ndarray:
    """8-point orthonormal DCT-II basis; a block transforms as D @ X @ D.T."""
    d = np.zeros((8, 8), np.float32)
    for k in range(8):
        for n in range(8):
            d[k, n] = np.cos((2 * n + 1) * k * np.pi / 16.0)
        d[k] *= (np.sqrt(1 / 8) if k == 0 else np.sqrt(2 / 8))
    return d


@lru_cache(maxsize=None)
def _constants(device: torch.device) -> dict:
    """The tables on ``device``, made once per device (no host-to-device
    copy per call)."""
    arrays = {"dct": _dct_matrix(), "y_table": Y_TABLE, "c_table": C_TABLE,
              "rgb2ycbcr": _RGB2YCBCR, "shift": _YCBCR_SHIFT, "ycbcr2rgb": _YCBCR2RGB}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def quality_to_factor(quality: torch.Tensor) -> torch.Tensor:
    """libjpeg quality scaling (reference diffjpeg.py:449-463)."""
    quality = quality.to(torch.float32)
    return torch.where(quality < 50, 5000.0 / quality, 200.0 - quality * 2.0) / 100.0


def diff_round(x: torch.Tensor) -> torch.Tensor:
    r = torch.round(x)
    return r + (x - r) ** 3


def _blockify(x: torch.Tensor) -> torch.Tensor:
    """(b, h, w) -> (b, blocks, 8, 8), blocks in row-major order."""
    b, h, w = x.shape
    return x.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4).reshape(b, -1, 8, 8)


def _unblockify(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = x.shape[0]
    return x.reshape(b, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4).reshape(b, h, w)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    b, h, w = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def diff_jpeg(img: torch.Tensor, quality: torch.Tensor, rounding=diff_round) -> torch.Tensor:
    """JPEG round trip of img (b, 3, h, w) RGB in [0, 1] at per-item
    ``quality`` (b,) (or a scalar tensor)."""
    c = _constants(img.device)
    b, _, h, w = img.shape
    ph, pw = (16 - h % 16) % 16, (16 - w % 16) % 16
    x = F.pad(img, (0, pw, 0, ph)) * 255.0     # zeros, cropped away at the end
    hp, wp = h + ph, w + pw

    ycc = torch.einsum("bchw,cd->bdhw", x, c["rgb2ycbcr"]) + c["shift"][:, None, None]
    y, cb, cr = ycc[:, 0], _avg_pool2(ycc[:, 1]), _avg_pool2(ycc[:, 2])
    factor = quality_to_factor(quality).expand(b).reshape(b, 1, 1, 1)
    dct = c["dct"]

    def roundtrip(chan, table, hh, ww):
        coefs = dct @ _blockify(chan - 128.0) @ dct.T
        q = table * factor       # raw table * factor: no libjpeg floor and clip (diffjpeg.py:169)
        coefs = rounding(coefs / q) * q
        return _unblockify(dct.T @ coefs @ dct, hh, ww) + 128.0

    y2 = roundtrip(y, c["y_table"], hp, wp)
    cb2 = _upsample2(roundtrip(cb, c["c_table"], hp // 2, wp // 2))
    cr2 = _upsample2(roundtrip(cr, c["c_table"], hp // 2, wp // 2))
    ycc2 = torch.stack([y2, cb2 - 128.0, cr2 - 128.0], dim=1)
    rgb = torch.einsum("bdhw,de->behw", ycc2, c["ycbcr2rgb"])
    return torch.clamp(rgb / 255.0, 0.0, 1.0)[:, :, :h, :w]
