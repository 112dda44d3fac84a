"""Color-space conversions, matlab-faithful (reference: utils/color_util.py).

Counterpart of ``ssl_tpu/utils/color_util.py``: numpy on HWC images, float32
[0, 1] RGB or uint8; YCbCr follows the BT.601 "matlab" convention the
reference metrics rely on."""

from __future__ import annotations

import numpy as np


def rgb2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """RGB [0,1] float or [0,255] uint8 -> YCbCr (matlab convention).
    Output same scale class as input (float stays [0,1]-scaled/255)."""
    img_type = img.dtype
    img = img.astype(np.float32)
    if img_type != np.uint8:
        img *= 255.0
    if y_only:
        out = img @ np.array([65.481, 128.553, 24.966], np.float32) / 255.0 + 16.0
    else:
        mat = np.array([[65.481, -37.797, 112.0],
                        [128.553, -74.203, -93.786],
                        [24.966, 112.0, -18.214]], np.float32)
        out = img @ mat / 255.0 + np.array([16, 128, 128], np.float32)
    if img_type != np.uint8:
        out /= 255.0
    else:
        out = out.round().astype(np.uint8)
    return out


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    return rgb2ycbcr(img[..., ::-1], y_only=y_only)


def to_y_channel(img: np.ndarray) -> np.ndarray:
    """HWC [0,255] image -> Y channel [0,255] float (reference metric_util.py)."""
    img = img.astype(np.float32) / 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        img = rgb2ycbcr(img, y_only=True)
        img = img[..., None]
    return img * 255.0
