"""LPIPS over a folder pair, without JAX: ``calculate_lpips_dists`` with
``--metric lpips`` (counterpart of ``scripts/metrics/calculate_lpips.py``).

    python -m ssl_tpu_torch.scripts.metrics.calculate_lpips --gt GT_dir --restored SR_dir
"""

from __future__ import annotations

import sys

from ssl_tpu_torch.scripts.metrics import calculate_lpips_dists


def main(argv=None):
    calculate_lpips_dists.main(["--metric", "lpips"] + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
