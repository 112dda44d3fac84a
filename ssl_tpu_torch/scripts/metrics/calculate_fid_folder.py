"""FID between two folders, or against precomputed GT statistics, without JAX.

    python -m ssl_tpu_torch.scripts.metrics.calculate_fid_folder --restored SR_dir \\
        (--gt GT_dir | --gt_stats stats.npz) [--save_stats out.npz] [--batch 8] \\
        [--limit 0] [--device cuda]

Counterpart of ``scripts/metrics/calculate_fid_folder.py``: the same flags
and lines, plus ``--device``.  The InceptionV3 weights come from
FID_INCEPTION_PTH (pt_inception-2015-12-05); without that file the script
refuses to run.  Each image is resized to 299 x 299
as ``cv2.resize(..., INTER_LINEAR)`` of the uint8 image: by cv2 where it
imports, else by ``resize_linear_u8``, which gives cv2's result bit for bit."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ssl_tpu_torch.metrics.fid import calculate_fid_from_stats, load_inception, stats_from_features
from ssl_tpu_torch.metrics.metric_util import exact_float32
from ssl_tpu_torch.utils.img_util import imread


def _linear_taps(n_src: int, n_dst: int, horizontal: bool):
    """OpenCV's INTER_LINEAR taps of one axis in its fixed point: source
    indices (i0, i1) clamped to the axis and weights summing to 2048, from
    float32 positions (d + 0.5) * scale - 0.5.  Horizontally a position
    outside the axis takes its edge pixel with weight 2048; vertically the
    two clamped rows keep their fractional weights."""
    pos = ((np.arange(n_dst, dtype=np.float64) + 0.5) * (n_src / n_dst) - 0.5).astype(np.float32)
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0.astype(np.float32)
    if horizontal:
        frac = np.where((i0 < 0) | (i0 >= n_src - 1), np.float32(0), frac)
    w0 = np.rint((np.float32(1) - frac) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(frac * np.float32(2048)).astype(np.int64)
    return np.clip(i0, 0, n_src - 1), np.clip(i0 + 1, 0, n_src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)``
    of an (h, w, c) uint8 image: the horizontal pass in 11-bit fixed point,
    the vertical one as OpenCV's vector loop rounds it,
    ((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16) + 2 >> 2."""
    x0, x1, a0, a1 = _linear_taps(img.shape[1], width, True)
    y0, y1, b0, b1 = _linear_taps(img.shape[0], height, False)
    src = img.astype(np.int64)
    rows = (src[:, x0] * a0[:, None] + src[:, x1] * a1[:, None]) >> 4
    out = ((rows[y0] * b0[:, None, None]) >> 16) + ((rows[y1] * b1[:, None, None]) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def _resize_299(img: np.ndarray) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        return resize_linear_u8(img, 299, 299)
    return cv2.resize(img, (299, 299), interpolation=cv2.INTER_LINEAR)


def folder_features(folder, model, batch=8, limit=0) -> np.ndarray:
    """(n, 2048) pool3 features of the folder's images (sorted by name, the
    first ``limit`` where given) in batches of ``batch`` on the model's device."""
    names = sorted(os.listdir(folder))
    if limit:
        names = names[:limit]
    device = next(model.parameters()).device
    feats, buf = [], []

    def flush():
        x = torch.from_numpy(np.stack(buf).transpose(0, 3, 1, 2)).to(device)
        with torch.no_grad(), exact_float32():
            feats.append(model(x).cpu().numpy())
        buf.clear()

    for name in names:
        img = imread(os.path.join(folder, name), float32=False)
        if img is None:
            continue
        buf.append(_resize_299(img)[..., ::-1].astype(np.float32) / 255.0)
        if len(buf) == batch:
            flush()
    if buf:
        flush()
    return np.concatenate(feats, 0)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--restored", required=True)
    parser.add_argument("--gt", default=None, help="GT folder (or use --gt_stats)")
    parser.add_argument("--gt_stats", default=None, help=".npz with mu/sigma")
    parser.add_argument("--save_stats", default=None, help="save restored-folder stats here")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    args = parser.parse_args(argv)

    model = load_inception(device=args.device)
    mu_r, sigma_r = stats_from_features(folder_features(args.restored, model, args.batch,
                                                        args.limit))
    if args.save_stats:
        np.savez(args.save_stats, mu=mu_r, sigma=sigma_r)
        print(f"saved stats to {args.save_stats}")
    if args.gt_stats:
        d = np.load(args.gt_stats)
        mu_g, sigma_g = d["mu"], d["sigma"]
    elif args.gt:
        mu_g, sigma_g = stats_from_features(folder_features(args.gt, model, args.batch,
                                                            args.limit))
    else:
        return
    fid = calculate_fid_from_stats(mu_r, sigma_r, mu_g, sigma_g)
    print(f"FID: {fid:.4f}")


if __name__ == "__main__":
    main()
