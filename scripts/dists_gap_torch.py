"""DISTS of the PyTorch port against ssl_tpu's, on the CPU.

    python3 scripts/dists_gap_torch.py

Both packages score the same seeded DISTS checkpoint in the official layout
(``tests/torch_metric_cases.py::write_dists``, seed 2) on 28 pairs: seven
seeded pictures from 64^2 to 208 x 112, each against three noisy copies and
an unrelated picture, crop_border 4, float32 in both.  DISTS is 1 - a score
near 1, so the gap is absolute; it prints one JSON line with the largest
absolute and relative gap and the smallest DISTS.  This sets the CPU tests'
``DISTS_ATOL`` (``tests/test_torch_metrics_suite.py``)."""

from __future__ import annotations

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

PICTURES = ((64, 64, 3), (64, 64, 40), (64, 64, 41), (208, 112, 60), (208, 112, 61),
            (96, 96, 7), (128, 80, 9))


def main() -> None:
    import torch
    from ssl_tpu.metrics import dists_metric as jdists
    from ssl_tpu_torch.metrics import dists_metric as tdists
    from torch_metric_cases import distorted, picture, write_dists

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as root:
        path, vgg16 = write_dists(root, seed=2)
        os.environ["VGG16_PTH"] = vgg16
        gaps = []
        for h, w, seed in PICTURES:
            a = picture(h, w, seed)
            for b in (distorted(a, 4), distorted(a, 0), distorted(a, 1),
                      picture(h, w, seed + 100)):
                want = jdists.calculate_dists(b, a, crop_border=4, weights_path=path)
                got = tdists.calculate_dists(b, a, 4, weights_path=path, device="cpu")
                gaps.append((abs(got - want), abs(got - want) / abs(want), want))
    print(json.dumps({"pairs": len(gaps), "max_abs_gap": max(g[0] for g in gaps),
                      "max_rel_gap": max(g[1] for g in gaps),
                      "min_dists": min(g[2] for g in gaps)}))


if __name__ == "__main__":
    main()
