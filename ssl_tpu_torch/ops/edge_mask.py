"""Edge-mask generation: Laplacian(grayscale) > threshold.

Counterpart of ``ssl_tpu/ops/edge_mask.py:16-74``.  Two paths with the same
semantics:

- ``edge_mask_np``: the offline path, byte-exact with the reference workflow
  (PIL 'L' grayscale + cv2.Laplacian CV_8U, generate_mask.py:17-41); it
  imports ``cv2`` when called.
- ``edge_mask_torch``: the tensor path on any device, equal to the JAX
  package's ``edge_mask_jax`` on NCHW batches."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def rgb_to_gray_l(img: np.ndarray) -> np.ndarray:
    """PIL 'L' conversion, bit-exact with Pillow's L24 fixed point:
    ``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16``.  img: HWC RGB uint8
    (or [0,1] float -> scaled)."""
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255.0).round().astype(np.uint8)
    img = img.astype(np.int64)
    gray = (img[..., 0] * 19595 + img[..., 1] * 38470 + img[..., 2] * 7471
            + 0x8000) >> 16
    return gray.astype(np.uint8)


def edge_mask_np(img: np.ndarray, threshold: float = 20.0, use_log: bool = False,
                 log_sigma: float = 1.0, color_mode: str = "L",
                 log_ksize: int = 0) -> np.ndarray:
    """Binary edge mask from an RGB image (reference generate_mask.py).

    cv2.Laplacian with CV_8U *saturates negatives to 0* — only positive
    responses survive, which the threshold then binarizes.  color_mode 'RGB'
    keeps the 3 channels; 'L' is the PIL-grayscale path.  ``log_ksize > 0``
    selects the LoG pre-blur ``GaussianBlur(ksize=(k,k), sigmaX=0)``,
    otherwise ``log_sigma`` is used directly."""
    import cv2
    if color_mode == "RGB":
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255.0).round().astype(np.uint8)
        src = img
    else:
        src = rgb_to_gray_l(img)
    if use_log:
        if log_ksize > 0:
            src = cv2.GaussianBlur(src, (log_ksize, log_ksize), 0)
        else:
            src = cv2.GaussianBlur(src, (0, 0), log_sigma)
    grad = cv2.Laplacian(src, cv2.CV_8U)  # saturating uint8 output
    return (grad > threshold).astype(np.float32)


def edge_mask_torch(img: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """(b, 3, h, w) RGB in [0, 1] -> (b, 1, h, w) float mask, on the input's
    device.  Reproduces the CV_8U saturation: the Laplacian response is
    clipped to [0, 255] and rounded before thresholding; every value is an
    integer below 2^24, so float32 holds it exactly."""
    u8 = torch.round(torch.clamp(img, 0, 1) * 255.0)
    gray = torch.floor((u8[:, 0] * 19595 + u8[:, 1] * 38470 + u8[:, 2] * 7471
                        + 32768.0) / 65536.0)
    g = F.pad(gray[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    lap = (g[:, :-2, 1:-1] + g[:, 2:, 1:-1] + g[:, 1:-1, :-2] + g[:, 1:-1, 2:]
           - 4.0 * g[:, 1:-1, 1:-1])
    grad = torch.clamp(torch.round(lap), 0, 255)
    return (grad > threshold).to(img.dtype)[:, None]
