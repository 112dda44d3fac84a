"""PSNR / SSIM over a folder pair, without JAX.

    python -m ssl_tpu_torch.scripts.metrics.calculate_psnr_ssim --gt GT_dir \\
        --restored SR_dir [--crop_border 4] [--test_y_channel] [--suffix '']

Counterpart of ``scripts/metrics/calculate_psnr_ssim.py``: the same flags
and lines (numpy float64, as there)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ssl_tpu_torch.metrics.psnr_ssim import calculate_psnr, calculate_ssim
from ssl_tpu_torch.scripts.metrics.folder_io import restored_path
from ssl_tpu_torch.utils.img_util import imread


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--gt", required=True)
    parser.add_argument("--restored", required=True)
    parser.add_argument("--crop_border", type=int, default=4)
    parser.add_argument("--suffix", default="", help="suffix of restored files")
    parser.add_argument("--test_y_channel", action="store_true")
    args = parser.parse_args(argv)

    psnrs, ssims = [], []
    for i, name in enumerate(sorted(os.listdir(args.gt))):
        gt = imread(os.path.join(args.gt, name), float32=False)
        path = restored_path(args.restored, name, args.suffix)
        if path is None:
            print(f"skip {name}: no restored file")
            continue
        sr = imread(path, float32=False)
        h = min(gt.shape[0], sr.shape[0])
        w = min(gt.shape[1], sr.shape[1])
        gt, sr = gt[:h, :w], sr[:h, :w]
        p = calculate_psnr(sr[..., ::-1], gt[..., ::-1], crop_border=args.crop_border,
                           test_y_channel=args.test_y_channel)
        s = calculate_ssim(sr[..., ::-1], gt[..., ::-1], crop_border=args.crop_border,
                           test_y_channel=args.test_y_channel)
        psnrs.append(p)
        ssims.append(s)
        print(f"{i+1:4d} {name:40s} PSNR: {p:.4f} dB  SSIM: {s:.4f}")
    print(f"Average: PSNR {np.mean(psnrs):.4f} dB, SSIM {np.mean(ssims):.4f}")


if __name__ == "__main__":
    main()
