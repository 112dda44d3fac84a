"""Back-projection post-processing of SR outputs, without JAX.

    python -m ssl_tpu_torch.scripts.back_projection --lr LR/ --pre results/ \\
        --out results_20bp [--mode bp|reverse_filter] [--scale 4] [--iters 20]

Counterpart of ``scripts/data_preparation/back_projection.py`` (the
reference's Matlab pack, scripts/matlab_scripts/back_projection/):

- ``--mode bp`` (backprojection.m + main_bp.m): iterative back-projection
  with a squared, renormalized fspecial('gaussian', 5, 1) correction filter;
- ``--mode reverse_filter`` (main_reverse_filter.m): x <- x + (up(lr) -
  up(down(x))).

Both resize with Matlab's antialiased bicubic (``utils/matlab_resize.py``, a
copy of the JAX package's) in float64.  A host program, as the JAX script is
(numpy and scipy; no array of it is on an accelerator).  Images go through
``utils/img_util.py``: ``cv2`` where it imports, else PNG through
``utils/png.py``."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ssl_tpu_torch.utils.img_util import imread, imwrite
from ssl_tpu_torch.utils.matlab_resize import imresize


def fspecial_gaussian(size: int = 5, sigma: float = 1.0) -> np.ndarray:
    """Matlab's fspecial('gaussian', size, sigma): truncated, normalized."""
    half = (size - 1) / 2.0
    y, x = np.mgrid[-half:half + 1, -half:half + 1]
    g = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    return g / g.sum()


def _conv2_same(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """conv2(..., 'same') per channel: zero padding (the kernel here is
    symmetric, so correlation is convolution)."""
    from scipy.ndimage import convolve
    out = np.empty_like(img)
    for c in range(img.shape[2]):
        out[:, :, c] = convolve(img[:, :, c], kernel, mode="constant", cval=0.0)
    return out


def backprojection(im_h: np.ndarray, im_l: np.ndarray, scale: int,
                   max_iter: int = 20) -> np.ndarray:
    """backprojection.m: p = fspecial('gaussian', 5, 1).^2 renormalized;
    im_h += conv2(up(im_l - down(im_h)), p, 'same') per iteration."""
    p = fspecial_gaussian(5, 1.0) ** 2
    p = p / p.sum()
    im_h = im_h.astype(np.float64)
    im_l = im_l.astype(np.float64)
    for _ in range(max_iter):
        im_l_s = imresize(im_h, 1.0 / scale)
        im_diff = imresize(im_l - im_l_s, float(scale))
        im_h = im_h + _conv2_same(im_diff, p)
    return im_h


def reverse_filter(im_out: np.ndarray, im_l: np.ndarray, scale: int,
                   max_iter: int = 20) -> np.ndarray:
    """main_reverse_filter.m: J = up(im_l); x += J - up(down(x))."""
    im_out = im_out.astype(np.float64)
    j = imresize(im_l.astype(np.float64), float(scale))
    for _ in range(max_iter):
        im_out = im_out + (j - imresize(imresize(im_out, 1.0 / scale), float(scale)))
    return im_out


def main(argv=None) -> list[str]:
    """Refine every PNG of ``--pre``; returns the names written."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lr", required=True, help="LR input folder (main_bp.m LR_folder)")
    ap.add_argument("--pre", required=True, help="SR output folder to refine")
    ap.add_argument("--out", required=True)
    ap.add_argument("--mode", choices=("bp", "reverse_filter"), default="bp")
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    names = sorted(n for n in os.listdir(args.pre) if n.endswith(".png"))
    fn = backprojection if args.mode == "bp" else reverse_filter
    for i, name in enumerate(names):
        print(f"{i + 1}/{len(names)} {name}", flush=True)
        im_l = imread(os.path.join(args.lr, name), float32=False).astype(np.float64) / 255.0
        im_h = imread(os.path.join(args.pre, name), float32=False).astype(np.float64) / 255.0
        out = fn(im_h, im_l, args.scale, args.iters)
        imwrite((np.clip(out, 0, 1) * 255.0).round().astype(np.uint8),
                os.path.join(args.out, name))
    return names


if __name__ == "__main__":
    main()
