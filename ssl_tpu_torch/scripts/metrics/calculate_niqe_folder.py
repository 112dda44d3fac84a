"""NIQE over a folder, without JAX.

    python -m ssl_tpu_torch.scripts.metrics.calculate_niqe_folder --input dir \\
        [--crop_border 0] [--pris_params params.npz]

Counterpart of ``scripts/metrics/calculate_niqe_folder.py``: the same flags
and lines (numpy float64 on the host, as there)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ssl_tpu_torch.metrics.niqe import calculate_niqe
from ssl_tpu_torch.utils.img_util import imread


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True)
    parser.add_argument("--crop_border", type=int, default=0)
    parser.add_argument("--pris_params", default=None)
    args = parser.parse_args(argv)

    scores = []
    for i, name in enumerate(sorted(os.listdir(args.input))):
        img = imread(os.path.join(args.input, name), float32=False)
        if img is None:
            continue
        score = calculate_niqe(img[..., ::-1].astype(np.float32), crop_border=args.crop_border,
                               pris_params_path=args.pris_params)
        scores.append(score)
        print(f"{i+1:4d} {name:40s} NIQE: {score:.4f}")
    print(f"Average NIQE: {np.mean(scores):.4f}")


if __name__ == "__main__":
    main()
