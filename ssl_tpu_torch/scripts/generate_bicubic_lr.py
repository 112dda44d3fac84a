"""LR synthesis from HR folders, without JAX.

    python -m ssl_tpu_torch.scripts.generate_bicubic_lr --input HR/ --output LR/ \\
        [--scale 4] [--mod 12] [--gt_output GT_mod12/] [--mode bicubic|realesrgan|bsrgan] \\
        [--list meta.txt]

Counterpart of ``scripts/data_preparation/generate_bicubic_lr.py`` (the
reference workflow of datasets/README_TEST.MD §1.2), with its flags and
file layout: each image is mod-cropped (``--mod``, 0 = off), optionally
saved to ``--gt_output``, then made LR by Matlab's antialiased bicubic
(``utils/matlab_resize.py``, a copy of the JAX package's, so the PNGs are
equal bit for bit), by the Real-ESRGAN two-stage degradation (a random
kernel set and the host degrader, ``data/realesr_degradation.py``) or by the
BSRGAN chain (``data/bsrgan_degradation.py``, cropped to a square of the
shorter LR side, as the JAX script leaves it).

This is a host program, as the JAX script is (numpy, scipy and the port's
host C++; no array of it is on an accelerator): the same computation in
the same place, not a fallback from the card.  The random modes draw from
the generators given to ``main`` (unseeded ones by default, as the JAX
script draws from the unseeded global streams), kernel synthesis first,
then the degradation.  Images go through ``utils/img_util.py``: ``cv2``
where it imports, else PNG through ``utils/png.py``."""

from __future__ import annotations

import argparse
import os
import random

import numpy as np

from ssl_tpu_torch.utils.img_util import imread, imwrite
from ssl_tpu_torch.utils.matlab_resize import imresize_uint8


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--scale", type=int, default=4)
    parser.add_argument("--mod", type=int, default=12, help="mod-crop GT first (0=off)")
    parser.add_argument("--gt_output", default=None, help="save mod-cropped GT here")
    parser.add_argument("--mode", choices=["bicubic", "realesrgan", "bsrgan"], default="bicubic")
    parser.add_argument("--list", dest="list_file", default=None,
                        help="meta list of relative sub-dirs/files (e.g. Vimeo90K "
                             "sep_trainlist.txt '00001/0001' septuplets); the structure is "
                             "mirrored under --output")
    return parser.parse_args(argv)


def list_names(input_dir: str, list_file: str | None) -> list[str]:
    """The relative names to convert: a meta list's entries (a directory
    entry expands to its sorted files) or the input folder's sorted names."""
    if not list_file:
        return sorted(os.listdir(input_dir))
    names = []
    with open(list_file) as f:
        for rel in (ln.strip() for ln in f if ln.strip()):
            full = os.path.join(input_dir, rel)
            if os.path.isdir(full):
                names.extend(os.path.join(rel, fn) for fn in sorted(os.listdir(full)))
            else:
                names.append(rel)
    return names


def realesrgan_lr(img_bgr: np.ndarray, synth, degrader) -> np.ndarray:
    """One BGR uint8 image through a drawn kernel set and the two-stage
    degradation -> the BGR uint8 LR."""
    rgb = img_bgr[..., ::-1].astype(np.float32) / 255.0
    k1, k2, sinc = synth.sample()
    lq = degrader.degrade_batch(rgb[None], k1[None], k2[None], sinc[None])[0]
    return (lq[..., ::-1] * 255).round().astype(np.uint8)


def bsrgan_lr(img_bgr: np.ndarray, scale: int, rng, np_rng) -> np.ndarray:
    """One BGR uint8 image through the BSRGAN chain, its LR cropped to a
    square of the shorter side // scale -> the BGR uint8 LR."""
    from ssl_tpu_torch.data.bsrgan_degradation import degradation_bsrgan
    rgb = img_bgr[..., ::-1].astype(np.float32) / 255.0
    lq, _ = degradation_bsrgan(rgb, scale, min(rgb.shape[0], rgb.shape[1]) // scale,
                               rng=rng, np_rng=np_rng)
    return (lq[..., ::-1] * 255).round().astype(np.uint8)


def main(argv=None, rng: random.Random | None = None,
         np_rng: np.random.RandomState | None = None) -> list[str]:
    """Write the LR (and mod-cropped GT) files; returns the names written."""
    args = parse_args(argv)
    rng = rng or random.Random()
    np_rng = np_rng or np.random.RandomState()
    os.makedirs(args.output, exist_ok=True)
    if args.gt_output:
        os.makedirs(args.gt_output, exist_ok=True)
    if args.mode == "realesrgan":
        from ssl_tpu_torch.data.realesr_degradation import RealESRGANDegrader
        from ssl_tpu_torch.data.realesrgan_dataset import _KernelSynth
        synth = _KernelSynth({}, rng, np_rng)
        degrader = RealESRGANDegrader({}, scale=args.scale, queue_size=0)
        degrader.rng, degrader.pyrng = np_rng, rng

    written = []
    for i, name in enumerate(list_names(args.input, args.list_file)):
        path = os.path.join(args.input, name)
        if not os.path.isfile(path):
            continue
        img = imread(path, float32=False)
        if img is None:                  # cv2 could not decode it: not an image
            continue
        os.makedirs(os.path.dirname(os.path.join(args.output, name)) or ".", exist_ok=True)
        if args.mod:
            h, w = img.shape[:2]
            img = img[: h - h % args.mod, : w - w % args.mod]
        if args.gt_output:
            imwrite(img, os.path.join(args.gt_output, name))
        if args.mode == "bicubic":
            lr = imresize_uint8(img, 1.0 / args.scale)
        elif args.mode == "realesrgan":
            lr = realesrgan_lr(img, synth, degrader)
        else:
            lr = bsrgan_lr(img, args.scale, rng, np_rng)
        imwrite(lr, os.path.join(args.output, name))
        written.append(name)
        if (i + 1) % 50 == 0:
            print(f"[{i + 1}]")
    print("done")
    return written


if __name__ == "__main__":
    main()
