"""InceptionV3 FID statistics of a GT folder, without JAX.

    python -m ssl_tpu_torch.scripts.metrics.calculate_fid_stats_from_GT --gt GT_dir \\
        --out stats.npz [--batch 8] [--limit 0] [--device cuda]

Counterpart of ``scripts/metrics/calculate_fid_stats_from_GT.py``: the same
flags and line, plus ``--device``; the weights as ``calculate_fid_folder``'s."""

from __future__ import annotations

import argparse

import numpy as np

from ssl_tpu_torch.metrics.fid import load_inception, stats_from_features
from ssl_tpu_torch.scripts.metrics.calculate_fid_folder import folder_features


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--gt", required=True)
    parser.add_argument("--out", required=True, help="output .npz (mu/sigma)")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    args = parser.parse_args(argv)

    feats = folder_features(args.gt, load_inception(device=args.device), args.batch, args.limit)
    mu, sigma = stats_from_features(feats)
    np.savez(args.out, mu=mu, sigma=sigma)
    print(f"saved FID stats for {len(feats)} images to {args.out}")


if __name__ == "__main__":
    main()
