"""PSNR / SSIM, matlab-faithful (reference: metrics/psnr_ssim.py).

Counterpart of ``ssl_tpu/metrics/psnr_ssim.py:16-142``.  ``calculate_psnr``
and ``calculate_ssim`` are numpy float64 on HWC [0, 255] images with the
reference's crop_border and test_y_channel options; SSIM uses the 11x11
sigma-1.5 Gaussian and the 'valid' window, computed here without ``cv2``
(separable sums in place of ``cv2.filter2D``, whose border the crop drops).
The ``_pt`` versions take (n, c, h, w) tensors in [0, 1] on any device and
return a per-image vector in float32, as the JAX ones do."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ssl_tpu_torch.utils.color_util import to_y_channel
from ssl_tpu_torch.utils.registry import METRIC_REGISTRY


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel(size, sigma) in float64: exp(-x^2 / 2 sigma^2),
    summed in order and scaled by the reciprocal of the sum."""
    x = np.arange(size, dtype=np.float64) - (size - 1) * 0.5
    t = np.exp((-0.5 / (sigma * sigma)) * x * x)
    total = 0.0
    for v in t:
        total += float(v)
    return t * (1.0 / total)


def _prep(img, img2, crop_border, test_y_channel, input_order="HWC"):
    if img.shape != img2.shape:
        raise ValueError(f"Image shapes are different: {img.shape}, {img2.shape}.")
    img = np.asarray(img, np.float64)
    img2 = np.asarray(img2, np.float64)
    if input_order == "CHW":
        img, img2 = img.transpose(1, 2, 0), img2.transpose(1, 2, 0)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img = to_y_channel(img)
        img2 = to_y_channel(img2)
    return img.astype(np.float64), img2.astype(np.float64)


@METRIC_REGISTRY.register()
def calculate_psnr(img, img2, crop_border=0, input_order="HWC", test_y_channel=False, **kwargs):
    img, img2 = _prep(img, img2, crop_border, test_y_channel, input_order)
    mse = np.mean((img - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 * 255.0 / mse)


def _filter_valid(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """The 'valid' part of img correlated with outer(k, k)."""
    n = len(k)
    h, w = img.shape
    rows = sum(k[j] * img[:, j:w - n + 1 + j] for j in range(n))
    return sum(k[i] * rows[i:h - n + 1 + i] for i in range(n))


def _ssim_single(img, img2):
    """SSIM for one channel, [0,255] float64, valid-window convolution."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    k = _gaussian_kernel()
    mu1, mu2 = _filter_valid(img, k), _filter_valid(img2, k)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter_valid(img ** 2, k) - mu1_sq
    sigma2_sq = _filter_valid(img2 ** 2, k) - mu2_sq
    sigma12 = _filter_valid(img * img2, k) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / \
               ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()


@METRIC_REGISTRY.register()
def calculate_ssim(img, img2, crop_border=0, input_order="HWC", test_y_channel=False, **kwargs):
    img, img2 = _prep(img, img2, crop_border, test_y_channel, input_order)
    ssims = [_ssim_single(img[..., i], img2[..., i]) for i in range(img.shape[2])]
    return float(np.mean(ssims))


def _rgb2ycbcr_pt(img: torch.Tensor, y_only: bool = False) -> torch.Tensor:
    """BT.601 RGB->YCbCr on (n, 3, h, w) [0,1] tensors (reference
    color_util.py:186-208, the batched torch flavor)."""
    x = img.permute(0, 2, 3, 1)
    if y_only:
        w = img.new_tensor([[65.481], [128.553], [24.966]])
        out = (x @ w).permute(0, 3, 1, 2) + 16.0
    else:
        w = img.new_tensor([[65.481, -37.797, 112.0],
                            [128.553, -74.203, -93.786],
                            [24.966, 112.0, -18.214]])
        b = img.new_tensor([16.0, 128.0, 128.0]).reshape(1, 3, 1, 1)
        out = (x @ w).permute(0, 3, 1, 2) + b
    return out / 255.0


def _prep_pt(img, img2, crop_border, test_y_channel):
    if img.shape != img2.shape:
        raise ValueError(f"Image shapes are different: {img.shape}, {img2.shape}.")
    img, img2 = img.float(), img2.float()
    if crop_border != 0:
        img = img[:, :, crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[:, :, crop_border:-crop_border, crop_border:-crop_border]
    if test_y_channel:
        img = _rgb2ycbcr_pt(img, y_only=True)
        img2 = _rgb2ycbcr_pt(img2, y_only=True)
    return img, img2


@METRIC_REGISTRY.register()
def calculate_psnr_pt(img, img2, crop_border, test_y_channel=False, **kwargs):
    """Batched PSNR (reference psnr_ssim.py:52-81): (n, 3/1, h, w) images in
    [0, 1], a per-image vector."""
    img, img2 = _prep_pt(img, img2, crop_border, test_y_channel)
    mse = torch.mean((img - img2) ** 2, dim=(1, 2, 3))
    return 10.0 * torch.log10(1.0 / (mse + 1e-8))


def _ssim_pt(img, img2):
    """(n, c, h, w) [0,255]: grouped valid-window Gaussian SSIM
    (reference psnr_ssim.py:201-231)."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    k = _gaussian_kernel()
    c = img.shape[1]
    w = img.new_tensor(np.outer(k, k)).expand(c, 1, 11, 11)

    def conv(x):
        return F.conv2d(x, w, groups=c)

    mu1, mu2 = conv(img), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = conv(img * img) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img * img2) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(1, 2, 3))


@METRIC_REGISTRY.register()
def calculate_ssim_pt(img, img2, crop_border, test_y_channel=False, **kwargs):
    """Batched SSIM (reference psnr_ssim.py:132-166): (n, 3/1, h, w) in
    [0, 1], a per-image vector."""
    img, img2 = _prep_pt(img, img2, crop_border, test_y_channel)
    return _ssim_pt(img * 255.0, img2 * 255.0)

