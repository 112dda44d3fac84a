"""Offline real-world LR test-set synthesis, without JAX.

    python -m ssl_tpu_torch.scripts.generate_realesrgan_bsrgan_lr \\
        --param_path options/generate/generate_RealESRGAN+BSRGAN_LR.yml \\
        --save_LR_path out/LR --save_bicubicSR_path out/bicubicSR [--realesrgan_prob 0.6]

Counterpart of ``scripts/data_preparation/generate_realesrgan_bsrgan_lr.py``
(reference scripts/data_preparation/generate_RealESRGAN+BSRGAN_LR.py with
options/generate/generate_RealESRGAN+BSRGAN_LR.yml): each GT image of each
``datasets`` root takes the Real-ESRGAN two-stage degradation (with
probability ``--realesrgan_prob``) or the BSRGAN chain over the whole image,
and its LR and that LR's bicubic x``scale`` upsampling (cv2's INTER_CUBIC on
uint8, or ``data/bsrgan_degradation.py::resize`` without cv2, equal to it at
x2 and x4) are saved as PNG.

The option file's ``manual_seed`` seeds a ``random.Random`` and a
``np.random.RandomState`` that this script owns (the JAX script seeds the
global streams); every draw comes from them in the JAX script's order: the
branch, then the kernel synthesis, then the degradation.  The JAX script's
degrader draws from its own unseeded streams instead, so its RealESRGAN
outputs change from run to run; here a seed fixes them.

A host program, as the JAX script is (numpy, scipy and the port's host C++;
no array of it is on an accelerator): the same computation in the same
place, not a fallback from the card.  A ``.json`` option file needs no
``yaml``; images go through ``utils/img_util.py`` (``cv2`` where it imports,
else PNG through ``utils/png.py``)."""

from __future__ import annotations

import argparse
import os
import random

import numpy as np

from ssl_tpu_torch.data.bsrgan_degradation import INTER_CUBIC, degradation_bsrgan, resize
from ssl_tpu_torch.data.realesr_degradation import RealESRGANDegrader
from ssl_tpu_torch.data.realesrgan_dataset import _KernelSynth
from ssl_tpu_torch.utils.img_util import imread, imwrite
from ssl_tpu_torch.utils.options import ordered_yaml_load


def realesrgan_lr(img: np.ndarray, opt: dict, scale: int, rng, np_rng) -> np.ndarray:
    """One RGB [0, 1] image through a drawn kernel set and a fresh two-stage
    degrader (no crop, no pool), both drawing from ``rng`` / ``np_rng``."""
    k1, k2, sinc = _KernelSynth(opt, rng, np_rng).sample()
    degrader = RealESRGANDegrader(opt, scale=scale, queue_size=0)
    degrader.rng, degrader.pyrng = np_rng, rng
    return degrader.degrade_batch(img[None], k1[None], k2[None], sinc[None])[0]


def bsrgan_lr(img: np.ndarray, scale: int, rng, np_rng) -> np.ndarray:
    """The BSRGAN shuffled chain over the whole image (no patch crop)."""
    h, w = img.shape[:2]
    lq, _ = degradation_bsrgan(img, sf=scale, lq_patchsize=min(h, w) // scale, no_crop=True,
                               rng=rng, np_rng=np_rng)
    return lq


def main(argv=None) -> list[tuple[str, str]]:
    """Write the LR and bicubic SR files; returns (name, branch) per image."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--param_path", required=True, help="generate-options YAML or JSON")
    parser.add_argument("--save_LR_path", required=True)
    parser.add_argument("--save_bicubicSR_path", required=True)
    parser.add_argument("--realesrgan_prob", type=float, default=0.6,
                        help="probability of the RealESRGAN branch (reference: 0.6)")
    args = parser.parse_args(argv)

    opt = ordered_yaml_load(args.param_path)
    seed = opt.get("manual_seed", 0)
    rng, np_rng = random.Random(seed), np.random.RandomState(seed)
    scale = opt.get("scale", 4)
    os.makedirs(args.save_LR_path, exist_ok=True)
    os.makedirs(args.save_bicubicSR_path, exist_ok=True)

    done = []
    for dataset, dataroot in (opt.get("datasets") or {}).items():
        root = dataroot["dataroot"]
        print(f"dataset {dataset}: {root}")
        for name in sorted(os.listdir(root)):
            path = os.path.join(root, name)
            if not os.path.isfile(path):
                continue
            img = imread(path, float32=False)
            if img is None:              # cv2 could not decode it: not an image
                continue
            img = img[..., ::-1].astype(np.float32) / 255.0          # RGB [0, 1]
            if rng.random() < args.realesrgan_prob:
                lq, tag = realesrgan_lr(img, opt.get("RealESRGAN", {}), scale, rng, np_rng), \
                    "realesrgan"
            else:
                lq, tag = bsrgan_lr(img, scale, rng, np_rng), "bsrgan"
            lq8 = (np.clip(lq, 0, 1) * 255.0).round().astype(np.uint8)
            base, _ = os.path.splitext(name)
            imwrite(lq8[..., ::-1], os.path.join(args.save_LR_path, base + ".png"))
            up = resize(lq8, (lq8.shape[1] * scale, lq8.shape[0] * scale), INTER_CUBIC)
            imwrite(up[..., ::-1], os.path.join(args.save_bicubicSR_path, base + ".png"))
            print(f"  {name}: {tag} -> {lq8.shape[1]}x{lq8.shape[0]}")
            done.append((name, tag))
    return done


if __name__ == "__main__":
    main()
