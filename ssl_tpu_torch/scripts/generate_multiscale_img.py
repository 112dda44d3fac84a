"""Multiscale copies of HR images, without JAX.

    python -m ssl_tpu_torch.scripts.generate_multiscale_img --input HR/ --output HR_multiscale/ \\
        [--scales 1 0.75 0.5 0.3333]

Counterpart of ``scripts/data_preparation/generate_multiscale_img.py``
(reference scripts/data_preparation/generate_multiscale_img.py): each image
at each scale through Matlab's antialiased bicubic (``utils/matlab_resize.py``,
a copy of the JAX package's, so the PNGs are equal bit for bit), saved as
``<name>T<j>.png``.  A host program, as the JAX script is (numpy; no array of
it is on an accelerator).  Images go through ``utils/img_util.py``: ``cv2``
where it imports, else PNG through ``utils/png.py``."""

from __future__ import annotations

import argparse
import os

from ssl_tpu_torch.utils.img_util import imread, imwrite
from ssl_tpu_torch.utils.matlab_resize import imresize_uint8


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--scales", type=float, nargs="+", default=[1.0, 0.75, 0.5, 1 / 3])
    args = parser.parse_args(argv)

    os.makedirs(args.output, exist_ok=True)
    names = sorted(os.listdir(args.input))
    for i, name in enumerate(names):
        img = imread(os.path.join(args.input, name), float32=False, flag="unchanged")
        base = os.path.splitext(name)[0]
        for j, s in enumerate(args.scales):
            out = img if s == 1.0 else imresize_uint8(img, s)
            imwrite(out, os.path.join(args.output, f"{base}T{j}.png"))
        if (i + 1) % 50 == 0:
            print(f"[{i + 1}/{len(names)}]")
    print("done")


if __name__ == "__main__":
    main()
