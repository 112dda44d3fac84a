"""RealESRGAN-style datasets: GT (+ edge mask) with per-item random blur kernels.

Counterpart of ``ssl_tpu/data/realesrgan_dataset.py`` (reference
data/realesrgan_dataset.py and my_realesrgan_image_mask_dataset.py:17-159):
each item is a GT crop and its two-stage blur kernels and final sinc
kernel, synthesized in ``__getitem__``; the pixel degradation runs later,
on the card, inside the train step (``ops/degrade.py``).  The calls on the
global ``random`` and ``np.random`` come in the JAX package's order, so one
seed gives its crops, flips and kernels.  Items are tensors: ``gt`` (3, h, w)
RGB in [0, 1], ``gt_mask`` (1, h, w), ``kernel1``, ``kernel2`` and
``sinc_kernel`` (21, 21) float32, and the ``gt_path`` string."""

from __future__ import annotations

import math
import os
import random

import numpy as np
import torch

from ssl_tpu_torch.data.data_util import paths_from_folder
from ssl_tpu_torch.data.degradations import circular_lowpass_kernel, random_mixed_kernels
from ssl_tpu_torch.data.paired_image_dataset import BaseDataset, load_mask
from ssl_tpu_torch.data.transforms import augment
from ssl_tpu_torch.utils.img_util import img2array, img2tensor, imread
from ssl_tpu_torch.utils.registry import DATASET_REGISTRY

_DEFAULTS = dict(
    blur_kernel_size=21,
    kernel_list=["iso", "aniso", "generalized_iso", "generalized_aniso",
                 "plateau_iso", "plateau_aniso"],
    kernel_prob=[0.45, 0.25, 0.12, 0.03, 0.12, 0.03],
    sinc_prob=0.1, blur_sigma=[0.2, 3], betag_range=[0.5, 4], betap_range=[1, 2],
    blur_kernel_size2=21,
    kernel_list2=["iso", "aniso", "generalized_iso", "generalized_aniso",
                  "plateau_iso", "plateau_aniso"],
    kernel_prob2=[0.45, 0.25, 0.12, 0.03, 0.12, 0.03],
    sinc_prob2=0.1, blur_sigma2=[0.2, 1.5], betag_range2=[0.5, 4], betap_range2=[1, 2],
    final_sinc_prob=0.8,
)


def _pulse(size: int = 21) -> np.ndarray:
    k = np.zeros((size, size), np.float32)
    k[size // 2, size // 2] = 1.0
    return k


class _KernelSynth:
    """Per-item two-stage + sinc kernel synthesis (reference
    my_realesrgan_image_mask_dataset.py __getitem__:88-141), each kernel
    zero-padded to 21 x 21.  The draws come from ``rng`` (a
    ``random.Random``) and ``np_rng`` (a ``np.random.RandomState``), the
    global ``random`` and ``np.random`` unless given, in the JAX order."""

    def __init__(self, opt: dict, rng: random.Random | None = None,
                 np_rng: np.random.RandomState | None = None):
        self.o = {**_DEFAULTS, **{k: v for k, v in opt.items() if k in _DEFAULTS}}
        self.kernel_range = [2 * v + 1 for v in range(3, 11)]  # 7..21
        self.rng, self.np_rng = rng, np_rng

    def _streams(self):
        return self.rng or random, self.np_rng or np.random

    def _blur_kernel(self, suffix: str) -> np.ndarray:
        o = self.o
        rng, np_rng = self._streams()
        ks = rng.choice(self.kernel_range)
        if np_rng.uniform() < o["sinc_prob" + suffix]:
            omega_c = np_rng.uniform(np.pi / 3 if ks < 13 else np.pi / 5, np.pi)
            kernel = circular_lowpass_kernel(omega_c, ks, pad_to=False)
        else:
            sigma = o["blur_sigma" + suffix]
            kernel = random_mixed_kernels(o["kernel_list" + suffix], o["kernel_prob" + suffix],
                                          ks, sigma, sigma, [-math.pi, math.pi],
                                          o["betag_range" + suffix], o["betap_range" + suffix],
                                          noise_range=None, rng=np_rng)
        pad = (21 - ks) // 2
        return np.pad(kernel, ((pad, pad), (pad, pad)))

    def sample(self):
        kernel = self._blur_kernel("")
        kernel2 = self._blur_kernel("2")
        rng, np_rng = self._streams()
        if np_rng.uniform() < self.o["final_sinc_prob"]:
            ks3 = rng.choice(self.kernel_range)
            omega_c = np_rng.uniform(np.pi / 3, np.pi)
            sinc = circular_lowpass_kernel(omega_c, ks3, pad_to=21)
        else:
            sinc = _pulse(21)
        return kernel.astype(np.float32), kernel2.astype(np.float32), sinc.astype(np.float32)


def _kernels(synth: _KernelSynth) -> dict:
    k1, k2, sinc = synth.sample()
    return {"kernel1": torch.from_numpy(k1), "kernel2": torch.from_numpy(k2),
            "sinc_kernel": torch.from_numpy(sinc)}


@DATASET_REGISTRY.register()
class RealESRGANDataset(BaseDataset):
    """GT + kernels, no mask (reference realesrgan_dataset.py)."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.paths = paths_from_folder(opt["dataroot_gt"])
        self.synth = _KernelSynth(opt)
        self.use_hflip = opt.get("use_hflip", True)
        self.use_rot = opt.get("use_rot", True)

    def __getitem__(self, index):
        img_gt = augment(img2array(imread(self.paths[index])), self.use_hflip, self.use_rot)
        return {"gt": img2tensor(img_gt), **_kernels(self.synth), "gt_path": self.paths[index]}


@DATASET_REGISTRY.register()
class MyRealESRGANImageMaskDataset(RealESRGANDataset):
    """GT + edge mask + kernels (reference my_realesrgan_image_mask_dataset.py):
    the GT sub-image and its mask (``.mat``, ``.npy`` or ``.png`` of the same
    base name under ``dataroot_gt_mask``), cropped together at one random
    place to ``crop_pre`` (400 in the shipped config) and augmented
    together."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.mask_root = opt["dataroot_gt_mask"]
        self.crop_pre = opt.get("crop_pre")

    def __getitem__(self, index):
        gt_path = self.paths[index]
        img_gt = img2array(imread(gt_path))
        base = os.path.splitext(os.path.basename(gt_path))[0]
        for ext in (".mat", ".npy", ".png"):
            cand = os.path.join(self.mask_root, base + ext)
            if os.path.exists(cand):
                mask = load_mask(cand)[..., None]
                break
        else:
            raise FileNotFoundError(f"no mask for {base} in {self.mask_root}")
        if self.crop_pre:
            h, w = img_gt.shape[:2]
            top = random.randint(0, max(h - self.crop_pre, 0))
            left = random.randint(0, max(w - self.crop_pre, 0))
            img_gt = img_gt[top:top + self.crop_pre, left:left + self.crop_pre]
            mask = mask[top:top + self.crop_pre, left:left + self.crop_pre]
        img_gt, mask = augment([img_gt, mask], self.use_hflip, self.use_rot)
        return {"gt": img2tensor(img_gt), "gt_mask": img2tensor(mask), **_kernels(self.synth),
                "gt_path": gt_path}
