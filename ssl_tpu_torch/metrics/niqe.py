"""NIQE — Natural Image Quality Evaluator (no-reference).

Counterpart of ``ssl_tpu/metrics/niqe.py`` (reference metrics/niqe.py:145-199):
numpy/scipy float64 on the host, as the JAX package computes it, with the
pristine multivariate-Gaussian statistics of ``niqe_pris_params.npz``
(a copy of the JAX package's file, next to this module).

The pristine parameters are fitted data, not code: they load from (in
order) a path argument, the NIQE_PRIS_PARAMS env var, or the file next to
this module; ``fit_niqe_params`` fits new ones from a folder of pristine
images.  ``convert_to='gray'`` computes cv2's float32 RGB2GRAY without
cv2 (``rgb_to_gray``)."""

from __future__ import annotations

import os

import numpy as np
from scipy.ndimage import convolve
from scipy.special import gamma

from ssl_tpu_torch.utils.color_util import to_y_channel
from ssl_tpu_torch.utils.matlab_resize import imresize
from ssl_tpu_torch.utils.registry import METRIC_REGISTRY


def _estimate_aggd(block: np.ndarray):
    """Asymmetric generalized Gaussian fit (moment matching)."""
    block = block.flatten()
    gam = np.arange(0.2, 10.001, 0.001)
    gam_reciprocal = np.reciprocal(gam)
    r_gam = np.square(gamma(gam_reciprocal * 2)) / (
        gamma(gam_reciprocal) * gamma(gam_reciprocal * 3))
    left_std = np.sqrt(np.mean(block[block < 0] ** 2)) if (block < 0).any() else 1e-6
    right_std = np.sqrt(np.mean(block[block > 0] ** 2)) if (block > 0).any() else 1e-6
    gammahat = left_std / right_std
    rhat = (np.mean(np.abs(block))) ** 2 / np.mean(block ** 2)
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)) / ((gammahat ** 2 + 1) ** 2)
    array_position = np.argmin((r_gam - rhatnorm) ** 2)
    alpha = gam[array_position]
    beta_l = left_std * np.sqrt(gamma(1 / alpha) / gamma(3 / alpha))
    beta_r = right_std * np.sqrt(gamma(1 / alpha) / gamma(3 / alpha))
    return alpha, beta_l, beta_r


def _block_features(img: np.ndarray) -> list[float]:
    feats = []
    alpha, beta_l, beta_r = _estimate_aggd(img)
    feats.extend([alpha, (beta_l + beta_r) / 2])
    shifts = [(0, 1), (1, 0), (1, 1), (1, -1)]
    for sh in shifts:
        shifted = np.roll(img, sh, axis=(0, 1))
        alpha, beta_l, beta_r = _estimate_aggd(img * shifted)
        mean = (beta_r - beta_l) * (gamma(2 / alpha) / gamma(1 / alpha))
        feats.extend([alpha, mean, beta_l, beta_r])
    return feats


def _mscn(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    mu = convolve(img, kernel, mode="nearest")
    sigma = np.sqrt(np.abs(convolve(img ** 2, kernel, mode="nearest") - mu ** 2))
    return (img - mu) / (sigma + 1)


def _gaussian_window(size=7, sigma=7 / 6):
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return k / k.sum()


def niqe_features(img: np.ndarray, block_size: int = 96) -> np.ndarray:
    """img: HxW [0,255] float (Y channel). Returns (n_blocks, 36) features."""
    kernel = _gaussian_window()
    h, w = img.shape
    num_bh, num_bw = h // block_size, w // block_size
    if num_bh == 0 or num_bw == 0:
        # same structural minimum as the reference/MATLAB NIQE (one 96-px
        # block at both scales); a tiny val crop would otherwise die inside
        # cv2.resize with an empty-size assertion
        raise ValueError(
            f"NIQE needs images of at least {block_size}x{block_size} px "
            f"after crop_border (got {h}x{w}).")
    img = img[: num_bh * block_size, : num_bw * block_size]
    feats_scales = []
    for scale in (1, 2):
        mscn = _mscn(img, kernel)
        feats = []
        bs = block_size // scale
        for by in range(num_bh):
            for bx in range(num_bw):
                block = mscn[by * bs:(by + 1) * bs, bx * bs:(bx + 1) * bs]
                feats.append(_block_features(block))
        feats_scales.append(np.asarray(feats))
        if scale == 1:
            # matlab-faithful antialiased bicubic, like the reference
            # (niqe.py:123 uses matlab_functions.imresize, not cv2)
            img = imresize(img / 255.0, 0.5) * 255.0
    return np.concatenate(feats_scales, axis=1)  # (blocks, 36)


def _fma32(a: np.ndarray, b: np.float32, c: np.ndarray) -> np.ndarray:
    """float32 a * b + c rounded once (the product is exact in float64)."""
    return (a.astype(np.float64) * np.float64(b) + c.astype(np.float64)).astype(np.float32)


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` of an (h, w, 3) float32
    image: 0.299 R + 0.587 G + 0.114 B in float32, fused as OpenCV's
    vector loop computes it, fma(B, 0.114, fma(R, 0.299, G * 0.587)).  On
    an AVX2 build, a row's last 4-7 pixels run a 4-wide loop that takes R
    first at its 1st and 3rd pixel; those may differ from cv2 by one
    float32 ulp."""
    r, g, b = (img[..., i].astype(np.float32) for i in range(3))
    return _fma32(b, np.float32(0.114), _fma32(r, np.float32(0.299), g * np.float32(0.587)))


def _load_pris_params(pris_params_path: str | None = None):
    path = (pris_params_path or os.environ.get("NIQE_PRIS_PARAMS") or
            os.path.join(os.path.dirname(__file__), "niqe_pris_params.npz"))
    if not os.path.exists(path):
        raise FileNotFoundError(
            "NIQE pristine parameters not found. Provide niqe_pris_params.npz via "
            "the NIQE_PRIS_PARAMS env var or fit your own with "
            "ssl_tpu_torch.metrics.niqe.fit_niqe_params(folder, out_path).")
    data = np.load(path)
    # official npz stores mu as (1, 36); self-fitted ones as (36,)
    return data["mu_pris_param"].reshape(-1), data["cov_pris_param"]


@METRIC_REGISTRY.register()
def calculate_niqe(img, crop_border=0, input_order="HWC", convert_to="y",
                   pris_params_path=None, **kwargs):
    """img: HWC [0,255] (uint8 or float). Lower is better."""
    mu_pris, cov_pris = _load_pris_params(pris_params_path)
    img = np.asarray(img, np.float64)
    if input_order == "CHW":
        img = img.transpose(1, 2, 0)
    if img.ndim == 3 and img.shape[2] == 3:
        if convert_to == "y":
            img = to_y_channel(img)[..., 0]
        else:
            img = rgb_to_gray((img / 255.0).astype(np.float32)) * 255.0
    elif img.ndim == 3:
        img = img[..., 0]
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    img = np.round(img)

    feats = niqe_features(img)
    mu_dist = np.nanmean(feats, axis=0)
    cov_dist = np.cov(feats[~np.isnan(feats).any(axis=1)], rowvar=False)
    x = mu_pris - mu_dist
    cov = (cov_pris + cov_dist) / 2
    quality = float(np.sqrt(max(x @ np.linalg.pinv(cov) @ x, 0)))
    return quality


def fit_niqe_params(folder: str, out_path: str, block_size: int = 96):
    """Fit pristine MVG parameters from a folder of high-quality images."""
    from ssl_tpu_torch.utils.img_util import imread
    all_feats = []
    for name in sorted(os.listdir(folder)):
        img = imread(os.path.join(folder, name), float32=False)
        if img is None:
            continue
        y = to_y_channel(img[..., ::-1].astype(np.float64))[..., 0]
        feats = niqe_features(np.round(y), block_size)
        # pristine fitting keeps only blocks with high sharpness; simplified:
        all_feats.append(feats)
    feats = np.concatenate(all_feats, axis=0)
    feats = feats[~np.isnan(feats).any(axis=1)]
    mu = feats.mean(axis=0)
    cov = np.cov(feats, rowvar=False)
    np.savez(out_path, mu_pris_param=mu, cov_pris_param=cov)
    return mu, cov
