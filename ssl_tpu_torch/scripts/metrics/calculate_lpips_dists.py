"""LPIPS or DISTS over a folder pair, without JAX.

    python -m ssl_tpu_torch.scripts.metrics.calculate_lpips_dists --metric lpips \\
        --gt GT_dir --restored SR_dir [--crop_border 4] [--suffix ''] \\
        [--weights ckpt] [--device cuda]

Counterpart of ``scripts/metrics/calculate_lpips_dists.py``: the same flags
and lines, plus ``--device``.  LPIPS reads LPIPS_ALEX_PTH (and ALEXNET_PTH
for the backbone), DISTS reads DISTS_PTH (and VGG16_PTH).  Images are read
BGR and flipped to RGB, the metrics' convention."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ssl_tpu_torch.metrics.dists_metric import calculate_dists
from ssl_tpu_torch.metrics.lpips_metric import calculate_lpips
from ssl_tpu_torch.scripts.metrics.folder_io import restored_path
from ssl_tpu_torch.utils.img_util import imread


def iter_pairs(gt_dir, restored_dir, suffix):
    for name in sorted(os.listdir(gt_dir)):
        path = restored_path(restored_dir, name, suffix)
        if path is None:
            print(f"skip {name}: no restored file")
            continue
        gt = imread(os.path.join(gt_dir, name), float32=False)
        yield name, gt[..., ::-1], imread(path, float32=False)[..., ::-1]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--metric", choices=["lpips", "dists"], required=True)
    parser.add_argument("--gt", required=True)
    parser.add_argument("--restored", required=True)
    parser.add_argument("--crop_border", type=int, default=4)
    parser.add_argument("--suffix", default="")
    parser.add_argument("--weights", default=None,
                        help="metric checkpoint (else LPIPS_ALEX_PTH/DISTS_PTH)")
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    args = parser.parse_args(argv)

    fn = calculate_lpips if args.metric == "lpips" else calculate_dists
    vals = []
    for i, (name, gt, restored) in enumerate(iter_pairs(args.gt, args.restored, args.suffix)):
        val = fn(restored, gt, crop_border=args.crop_border, weights_path=args.weights,
                 device=args.device)
        vals.append(val)
        print(f"{i + 1:3d} {name:25}. \t{args.metric.upper()}: {val:.6f}")
    if vals:
        print(f"Average {args.metric.upper()}: {np.mean(vals):.6f} ({len(vals)} images)")


if __name__ == "__main__":
    main()
