"""CLIP-IQA over a folder (no reference), without JAX.

    python -m ssl_tpu_torch.scripts.metrics.calculate_clipiqa --restored dir \\
        [--weights clip_rn50.pt] [--prompt_tokens tokens.npy] [--device cuda]

Counterpart of ``scripts/metrics/calculate_clipiqa.py``: the same flags and
lines, plus ``--device``.  Needs CLIP_RN50_PTH (or ``--weights``) and the
prompt token ids (``--prompt_tokens``, CLIP_PROMPT_TOKENS_NPY or the BPE
merges at CLIP_BPE_PATH)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ssl_tpu_torch.metrics.clipiqa import calculate_clipiqa
from ssl_tpu_torch.utils.img_util import imread


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--restored", required=True)
    parser.add_argument("--weights", default=None)
    parser.add_argument("--prompt_tokens", default=None, help=".npy (2,77) int ids")
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    args = parser.parse_args(argv)

    tokens = np.load(args.prompt_tokens) if args.prompt_tokens else None
    vals = []
    for i, name in enumerate(sorted(os.listdir(args.restored))):
        img = imread(os.path.join(args.restored, name), float32=False)
        if img is None:
            continue
        val = calculate_clipiqa(img[..., ::-1], weights_path=args.weights, prompt_tokens=tokens,
                                device=args.device)
        vals.append(val)
        print(f"{i + 1:3d} {name:25}. \tCLIPIQA: {val:.6f}")
    if vals:
        print(f"Average CLIPIQA: {np.mean(vals):.6f} ({len(vals)} images)")


if __name__ == "__main__":
    main()
