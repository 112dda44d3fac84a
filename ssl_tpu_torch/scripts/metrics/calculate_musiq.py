"""MUSIQ over a folder, without JAX.

    python -m ssl_tpu_torch.scripts.metrics.calculate_musiq --restored dir

Counterpart of ``scripts/metrics/calculate_musiq.py``: like the reference,
it delegates to the ``pyiqa`` package and raises where that does not import."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ssl_tpu_torch.metrics.clipiqa import calculate_musiq
from ssl_tpu_torch.utils.img_util import imread


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--restored", required=True)
    args = parser.parse_args(argv)

    vals = []
    for i, name in enumerate(sorted(os.listdir(args.restored))):
        img = imread(os.path.join(args.restored, name), float32=False)
        if img is None:
            continue
        val = calculate_musiq(img[..., ::-1])
        vals.append(val)
        print(f"{i + 1:3d} {name:25}. \tMUSIQ: {val:.6f}")
    if vals:
        print(f"Average MUSIQ: {np.mean(vals):.6f} ({len(vals)} images)")


if __name__ == "__main__":
    main()
