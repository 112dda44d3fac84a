"""The two-stage-degradation datasets of the diffusion tree, and the
Real-ESRGAN paired set.

Counterpart of ``ssl_tpu/data/extra_datasets.py`` for
``TwoStageDegradationImgMaskDataset`` (:104-162, the StableSR-SSL training
set) and ``TwoStageDegradationDF2KDataset`` (:75-100), each registered also
under the reference's spelling, and ``RealESRGANPairedDataset`` (:28-53).
Crops, flips and kernels take the global ``random`` and ``np.random`` draws
in the JAX package's order, so one seed gives its items; images become CHW
float32 tensors (``gt`` (3, h, w) RGB in [0, 1], ``gt_mask`` (1, h, w), the
kernels (21, 21)).  The rest of that file (``FFHQDataset``,
``FFHQDegradationDataset``) is not ported yet (ROADMAP.md)."""

from __future__ import annotations

import os
import random

import torch

from ssl_tpu_torch.data.data_util import (paired_paths_from_folders,
                                          paired_paths_from_meta_info_file, paths_from_folder)
from ssl_tpu_torch.data.paired_image_dataset import BaseDataset, load_mask
from ssl_tpu_torch.data.realesr_degradation import RealESRGANDegrader
from ssl_tpu_torch.data.realesrgan_dataset import _kernels, _KernelSynth
from ssl_tpu_torch.data.transforms import augment, paired_random_crop
from ssl_tpu_torch.utils.img_util import img2array, img2tensor, imread
from ssl_tpu_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class RealESRGANPairedDataset(BaseDataset):
    """LQ / GT pairs listed by a ``meta_info`` file (its first column, the GT
    names) or, without one, paired by name from the two folders (reference
    realesrgan_paired_dataset.py); in the train phase a random aligned crop
    of ``gt_size`` and flips / rotations (``use_hflip``, ``use_rot``, both on
    unless the options say otherwise)."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.scale = opt.get("scale", 4)
        folders, tmpl = [opt["dataroot_lq"], opt["dataroot_gt"]], opt.get("filename_tmpl", "{}")
        if opt.get("meta_info"):
            self.paths = paired_paths_from_meta_info_file(folders, ["lq", "gt"],
                                                          opt["meta_info"], tmpl)
        else:
            self.paths = paired_paths_from_folders(folders, ["lq", "gt"], tmpl)
        self.phase = opt.get("phase", "train")
        self.gt_size = opt.get("gt_size")

    def __getitem__(self, index):
        d = self.paths[index]
        img_gt = img2array(imread(d["gt_path"]))
        img_lq = img2array(imread(d["lq_path"]))
        if self.phase == "train":
            img_gt, img_lq = paired_random_crop(img_gt, img_lq, self.gt_size, self.scale)
            img_gt, img_lq = augment([img_gt, img_lq], self.opt.get("use_hflip", True),
                                     self.opt.get("use_rot", True))
        return {"lq": img2tensor(img_lq), "gt": img2tensor(img_gt), "lq_path": d["lq_path"],
                "gt_path": d["gt_path"]}


@DATASET_REGISTRY.register()
@DATASET_REGISTRY.register(name="TwoStageDegradation_DF2K_Dataset")
class TwoStageDegradationDF2KDataset(BaseDataset):
    """GT crops of ``gt_size`` and their two-stage degraded LQ, made in
    ``__getitem__`` by a ``RealESRGANDegrader`` without a pool (reference
    twostagedegradation_df2k_dataset.py).  The degrader is made in the
    process that first reads an item, seeded from the loader worker's torch
    seed (unseeded in the main process, as the JAX package's is), so worker
    processes draw distinct degradations."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.scale = opt.get("scale", 4)
        self.paths = paths_from_folder(opt["dataroot_gt"])
        self.gt_size = opt.get("gt_size", 256)
        self.synth = _KernelSynth(opt)
        self._degrader, self._pid = None, None

    def degrader(self) -> RealESRGANDegrader:
        if self._pid != os.getpid():
            info = torch.utils.data.get_worker_info()
            self._degrader = RealESRGANDegrader(
                self.opt, scale=self.scale, queue_size=0,
                seed=None if info is None else info.seed % 2 ** 32, threads=1)
            self._pid = os.getpid()
        return self._degrader

    def __getitem__(self, index):
        img_gt = img2array(imread(self.paths[index]))
        h, w = img_gt.shape[:2]
        size = self.gt_size
        top = random.randint(0, max(h - size, 0))
        left = random.randint(0, max(w - size, 0))
        img_gt = img_gt[top:top + size, left:left + size]
        img_gt = augment(img_gt, self.opt.get("use_hflip", True), self.opt.get("use_rot", True))
        k1, k2, sinc = self.synth.sample()
        lq = self.degrader().degrade_batch(img_gt[None], k1[None], k2[None], sinc[None])[0]
        return {"gt": img2tensor(img_gt), "lq": img2tensor(lq), "gt_path": self.paths[index]}


@DATASET_REGISTRY.register()
@DATASET_REGISTRY.register(name="TwoStageDegradation_Img_Mask_Dataset")
class TwoStageDegradationImgMaskDataset(BaseDataset):
    """The StableSR-SSL training set (reference
    twostagedegradation_img_mask_dataset.py:19-119): GT images from one or
    more roots (and optionally ``num_face`` images of ``face_gt_path``), each
    with the mask of its base name (``.mat``, ``.npy`` or ``.png``) under the
    matching mask root; a random ``crop_size`` crop of both, a horizontal
    flip, and the item's blur and sinc kernels.  The pixel degradation runs
    later, on the batch (``RealESRGANDegrader`` in the training CLI)."""

    def __init__(self, opt: dict):
        self.opt = opt
        gt_roots = opt["dataroot_gt"]
        if isinstance(gt_roots, str):
            gt_roots = [gt_roots]
        mask_roots = opt["dataroot_gt_mask"]
        if isinstance(mask_roots, str):
            mask_roots = [mask_roots] * len(gt_roots)
        self.items = [(p, mroot) for groot, mroot in zip(gt_roots, mask_roots)
                      for p in paths_from_folder(groot)]
        face_root = opt.get("face_gt_path")
        if face_root:
            face_paths = paths_from_folder(face_root)
            if opt.get("num_face"):
                face_paths = face_paths[:opt["num_face"]]
            self.items += [(p, opt.get("face_mask_path", mask_roots[0])) for p in face_paths]
        self.paths = [p for p, _ in self.items]
        self.crop_size = opt.get("crop_size", 512)
        self.synth = _KernelSynth(opt)

    def __getitem__(self, index):
        gt_path, mask_root = self.items[index]
        img_gt = img2array(imread(gt_path))
        base = os.path.splitext(os.path.basename(gt_path))[0]
        for ext in (".mat", ".npy", ".png"):
            cand = os.path.join(mask_root, base + ext)
            if os.path.exists(cand):
                mask = load_mask(cand)[..., None]
                break
        else:
            raise FileNotFoundError(f"mask for {base} not found in {mask_root} (the reference "
                                    "asserts filename<->mask correspondence)")
        if mask.shape[:2] != img_gt.shape[:2]:
            raise ValueError(f"mask/GT size mismatch for {base}: {mask.shape} vs {img_gt.shape}")
        h, w = img_gt.shape[:2]
        size = min(self.crop_size, h, w)
        top = random.randint(0, h - size)
        left = random.randint(0, w - size)
        img_gt = img_gt[top:top + size, left:left + size]
        mask = mask[top:top + size, left:left + size]
        img_gt, mask = augment([img_gt, mask], self.opt.get("use_hflip", True), False)
        return {"gt": img2tensor(img_gt), "gt_mask": img2tensor(mask),
                **_kernels(self.synth), "gt_path": gt_path}
