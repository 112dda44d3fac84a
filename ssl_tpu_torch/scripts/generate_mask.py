"""Offline edge-mask generation, without JAX.

    python -m ssl_tpu_torch.scripts.generate_mask --input datasets/DF2K_OST/multiscale_HR_sub_512 \\
        --output datasets/DF2K_OST/mask_selfsim [--threshold 20] [--mode Laplacian|LoG] \\
        [--color_mode L|RGB] [--no_png]

Counterpart of ``scripts/data_preparation/generate_mask.py`` (reference
scripts/data_preparation/generate_mask.py), with its flags and file layout:
for each image, grayscale 'L' (or RGB) -> optional LoG pre-blur -> Laplacian
CV_8U -> threshold, saved under ``<output>/<mode>/<color_mode>/threshold-<t>/``
as ``mat/<name>.mat`` (key ``mat``, float64), ``png/<name>.png`` (mask x 255)
and ``edge_pixel_stats.txt`` (name, edge pixels, share).

With ``cv2`` the masks come from ``ops/edge_mask.py::edge_mask_np``, equal
to the JAX script's.  Without it, Laplacian 'L' masks come from
``edge_mask_torch`` (the JAX package's ``edge_mask_jax``: its one-pixel
border repeats the edge where cv2 reflects, so border pixels may differ),
PNG goes through ``utils/png.py``, and LoG or RGB raise."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ssl_tpu_torch.ops.edge_mask import edge_mask_np, edge_mask_torch
from ssl_tpu_torch.utils.img_util import imread, imwrite


def _have_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def edge_mask(img: np.ndarray, args) -> np.ndarray:
    """The mask of one HWC RGB uint8 image under the parsed ``args``."""
    if _have_cv2():
        return edge_mask_np(img, args.threshold, use_log=(args.mode == "LoG"),
                            log_sigma=args.log_sigma, color_mode=args.color_mode,
                            log_ksize=args.gaussian_kernel_size)
    if args.mode != "Laplacian" or args.color_mode != "L":
        raise ImportError(f"--mode {args.mode} --color_mode {args.color_mode} needs cv2; "
                          "without it only Laplacian L masks are made")
    x = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))[None].float() / 255.0
    return edge_mask_torch(x, args.threshold)[0, 0].numpy()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--threshold", type=float, default=20.0)
    parser.add_argument("--mode", type=str, default="Laplacian", choices=["Laplacian", "LoG"])
    parser.add_argument("--log_sigma", type=float, default=1.0)
    parser.add_argument("--color_mode", type=str, default="L", choices=["L", "RGB"],
                        help="simmatrix --mode: RGB keeps a 3-channel mask")
    parser.add_argument("--gaussian_kernel_size", type=int, default=0,
                        help="simmatrix LoG pre-blur ksize (sigma from ksize); "
                             "0 = use --log_sigma")
    parser.add_argument("--no_png", action="store_true", help="skip .png previews")
    return parser.parse_args(argv)


def main(argv=None) -> str:
    """Write the masks; returns the ``mat`` folder."""
    from scipy.io import savemat
    args = parse_args(argv)
    tag = f"{args.mode}/{args.color_mode}/threshold-{args.threshold}"
    mat_dir = os.path.join(args.output, tag, "mat")
    png_dir = os.path.join(args.output, tag, "png")
    os.makedirs(mat_dir, exist_ok=True)
    if not args.no_png:
        os.makedirs(png_dir, exist_ok=True)

    stats = []
    names = sorted(os.listdir(args.input))
    for i, name in enumerate(names):
        path = os.path.join(args.input, name)
        if not os.path.isfile(path):
            continue
        img = imread(path, float32=False)
        if img is None:                  # cv2 could not decode it: not an image
            continue
        mask = edge_mask(np.ascontiguousarray(img[..., ::-1]), args)   # BGR -> RGB
        base = os.path.splitext(name)[0]
        savemat(os.path.join(mat_dir, base + ".mat"), {"mat": mask.astype(np.float64)})
        if not args.no_png:
            png = (mask * 255).astype(np.uint8)
            if png.ndim == 3:
                png = png[..., ::-1]     # RGB mask -> BGR for imwrite
            imwrite(png, os.path.join(png_dir, base + ".png"))
        stats.append(f"{name} {int(mask.sum())} {float(mask.mean()):.6f}")
        if (i + 1) % 100 == 0:
            print(f"[{i + 1}/{len(names)}] {name}")

    with open(os.path.join(args.output, tag, "edge_pixel_stats.txt"), "w") as f:
        f.write("\n".join(stats) + "\n")
    print(f"done: {len(stats)} masks -> {mat_dir}")
    return mat_dir


if __name__ == "__main__":
    main()
