"""Paired LQ/GT datasets, with and without edge masks.

Counterpart of ``ssl_tpu/data/paired_image_dataset.py:19-162`` (reference
parity: data/paired_image_dataset.py, paired_image_mask_dataset.py,
single_image_dataset.py, multiLR_oneGT_dataset.py).  The pipeline is the JAX
one (same decode, crops and draws on HWC numpy arrays); each item's images
then become CHW float32 tensors, as BasicSR gives them: ``lq`` and ``gt``
(3, h, w) RGB in [0, 1], ``gt_mask`` (1, h, w)."""

from __future__ import annotations

import os

import numpy as np

from ssl_tpu_torch.data.data_util import (paired_paths_from_folders, paired_paths_from_lmdb,
                                          paired_paths_from_meta_info_file,
                                          paired_paths_with_mask, paths_from_folder)
from ssl_tpu_torch.data.file_client import FileClient
from ssl_tpu_torch.data.transforms import augment, paired_random_crop, paired_random_crop_img_mask
from ssl_tpu_torch.utils.img_util import img2array, img2tensor, imfrombytes, imread
from ssl_tpu_torch.utils.registry import DATASET_REGISTRY


def load_mask(path: str) -> np.ndarray:
    """Load a binary edge mask saved as .mat (key 'mat'), .npy or .png
    (reference masks: generate_mask.py saves scipy.io .mat with key 'mat')."""
    if path.endswith(".mat"):
        from scipy.io import loadmat
        m = loadmat(path)["mat"]
    elif path.endswith(".npy"):
        m = np.load(path)
    else:
        m = imread(path, float32=False, flag="grayscale")
        m = (m > 127).astype(np.float32)
    m = np.asarray(m).astype(np.float32)
    if m.ndim == 3:
        m = m[..., 0]
    return m


def _tensors(item: dict) -> dict:
    return {k: img2tensor(v) if isinstance(v, np.ndarray) else v for k, v in item.items()}


class BaseDataset:
    def __len__(self):
        return len(self.paths)


@DATASET_REGISTRY.register()
class PairedImageDataset(BaseDataset):
    """Classic paired folder/meta dataset (reference paired_image_dataset.py)."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.scale = opt.get("scale", 4)
        gt_folder, lq_folder = opt["dataroot_gt"], opt["dataroot_lq"]
        tmpl = opt.get("filename_tmpl", "{}")
        # io_backend (reference paired_image_dataset.py:56-66): 'disk'
        # (default) reads files; 'lmdb' treats the dataroots as .lmdb dirs
        # with meta_info.txt key lists and fetches encoded bytes by key.
        self.io_backend_opt = dict(opt.get("io_backend") or {"type": "disk"})
        self.file_client = None   # built lazily (per dataloader worker)
        if self.io_backend_opt.get("type") == "lmdb":
            self.io_backend_opt["db_paths"] = [lq_folder, gt_folder]
            self.io_backend_opt["client_keys"] = ["lq", "gt"]
            self.paths = paired_paths_from_lmdb([lq_folder, gt_folder], ["lq", "gt"])
        elif opt.get("meta_info_file"):
            self.paths = paired_paths_from_meta_info_file(
                [lq_folder, gt_folder], ["lq", "gt"], opt["meta_info_file"], tmpl)
        else:
            self.paths = paired_paths_from_folders([lq_folder, gt_folder], ["lq", "gt"], tmpl)
        self.phase = opt.get("phase", "train")
        self.gt_size = opt.get("gt_size")
        self.use_hflip = opt.get("use_hflip", False)
        self.use_rot = opt.get("use_rot", False)

    def _read(self, path: str, client_key: str) -> np.ndarray:
        if self.file_client is None:
            kw = dict(self.io_backend_opt)
            self.file_client = FileClient(kw.pop("type"), **kw)
        return imfrombytes(self.file_client.get(path, client_key), float32=True)

    def __getitem__(self, index):
        d = self.paths[index]
        img_gt = img2array(self._read(d["gt_path"], "gt"))
        img_lq = img2array(self._read(d["lq_path"], "lq"))
        if self.phase == "train":
            img_gt, img_lq = paired_random_crop(img_gt, img_lq, self.gt_size, self.scale)
            img_gt, img_lq = augment([img_gt, img_lq], self.use_hflip, self.use_rot)
        else:
            # center-consistent: crop GT to match LQ*scale
            h, w = img_lq.shape[:2]
            img_gt = img_gt[: h * self.scale, : w * self.scale, :]
        return _tensors({"lq": img_lq, "gt": img_gt, "lq_path": d["lq_path"],
                         "gt_path": d["gt_path"]})


@DATASET_REGISTRY.register()
class MyPairedImageDataset(PairedImageDataset):
    """Simplified paired dataset used by tests in the reference (my_paired_image_dataset.py)."""


@DATASET_REGISTRY.register()
class PairedImageMaskDataset(BaseDataset):
    """GT + LQ + offline Laplacian edge mask for SSL training
    (reference paired_image_mask_dataset.py:14-98)."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.scale = opt.get("scale", 4)
        tmpl = opt.get("filename_tmpl", "{}")
        self.paths = paired_paths_with_mask(
            [opt["dataroot_lq"], opt["dataroot_gt"], opt["dataroot_gt_mask"]],
            ["lq", "gt", "gt_mask"], tmpl)
        self.phase = opt.get("phase", "train")
        self.gt_size = opt.get("gt_size")
        self.use_hflip = opt.get("use_hflip", True)
        self.use_rot = opt.get("use_rot", True)

    def __getitem__(self, index):
        d = self.paths[index]
        img_gt = img2array(imread(d["gt_path"]))
        img_lq = img2array(imread(d["lq_path"]))
        mask = load_mask(d["gt_mask_path"])[..., None]  # HW1
        if self.phase == "train":
            img_gt, img_lq, mask = paired_random_crop_img_mask(
                img_gt, img_lq, mask, self.gt_size, self.scale)
            img_gt, img_lq, mask = augment([img_gt, img_lq, mask], self.use_hflip, self.use_rot)
        return _tensors({"lq": img_lq, "gt": img_gt, "gt_mask": mask,
                         "lq_path": d["lq_path"], "gt_path": d["gt_path"]})


@DATASET_REGISTRY.register()
class SingleImageDataset(BaseDataset):
    """LQ-only inference dataset (reference single_image_dataset.py)."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.paths = paths_from_folder(opt["dataroot_lq"])

    def __getitem__(self, index):
        path = self.paths[index]
        return _tensors({"lq": img2array(imread(path)), "lq_path": path})


@DATASET_REGISTRY.register()
class MultiLROneGTDataset(BaseDataset):
    """Several LR variants per GT (reference multiLR_oneGT_dataset.py:1-52),
    the test sets of RealESRGAN-SSL: ``dataroot_lq`` holds one subfolder per
    degradation, each with LQ files named as their GT; GT is cropped to LQ x
    scale.  Items also carry the ``variant`` (the subfolder's name)."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.scale = opt.get("scale", 4)
        lq_root = opt["dataroot_lq"]
        subdirs = sorted(d for d in os.listdir(lq_root) if os.path.isdir(os.path.join(lq_root, d)))
        self.paths = []
        for gt in paths_from_folder(opt["dataroot_gt"]):
            base = os.path.basename(gt)
            for sub in subdirs:
                lq = os.path.join(lq_root, sub, base)
                if os.path.exists(lq):
                    self.paths.append({"gt_path": gt, "lq_path": lq, "variant": sub})

    def __getitem__(self, index):
        d = self.paths[index]
        img_gt = img2array(imread(d["gt_path"]))
        img_lq = img2array(imread(d["lq_path"]))
        h, w = img_lq.shape[:2]
        return _tensors({"lq": img_lq, "gt": img_gt[: h * self.scale, : w * self.scale, :], **d})


@DATASET_REGISTRY.register()
class SingleImageNPDataset(BaseDataset):
    """CFW stage-2 quadruplets (reference single_image_dataset.py:76-164;
    ``ssl_tpu/data/paired_image_dataset.py:169-228``): the aligned
    ``{gts,inputs,latents,samples}`` folders under ``gt_path`` (one root or a
    list), as ``ssl_tpu_torch.scripts.gt_input_output`` dumps them.  Items:
    ``lq``, ``gt`` and ``sample`` (3, h, w) RGB in [0, 1] (normalised by
    ``mean`` / ``std`` when given; ``color: y`` keeps the Y channel), and the
    ``latent`` (c, h, w).  Both latent layouts load: the JAX and the port's
    dumps save (h, w, c), the reference's (1, c, h, w)."""

    def __init__(self, opt: dict):
        import glob

        self.opt = opt
        image_type = opt.get("image_type", "png")
        roots = opt["gt_path"]
        if isinstance(roots, str):
            roots = [roots]
        self.gt_paths, self.lq_paths, self.np_paths, self.sample_paths = [], [], [], []
        for root in roots:
            def listing(sub, pattern):
                return sorted(glob.glob(os.path.join(root, sub, pattern)))
            self.gt_paths += listing("gts", "*." + image_type)
            self.lq_paths += listing("inputs", "*." + image_type)
            self.np_paths += listing("latents", "*.npy")
            self.sample_paths += listing("samples", "*." + image_type)
        if not (len(self.gt_paths) == len(self.lq_paths) == len(self.np_paths)
                == len(self.sample_paths)):
            raise ValueError("gts/inputs/latents/samples must align")
        self.mean, self.std = opt.get("mean"), opt.get("std")

    def __len__(self):
        return len(self.gt_paths)

    def _norm(self, img: np.ndarray) -> np.ndarray:
        if self.mean is not None or self.std is not None:
            mean = np.asarray(self.mean if self.mean is not None else 0.0, np.float32)
            std = np.asarray(self.std if self.std is not None else 1.0, np.float32)
            img = (img - mean) / std
        return img

    def __getitem__(self, index):
        lq = img2array(imread(self.lq_paths[index]))
        gt = img2array(imread(self.gt_paths[index]))
        sample = img2array(imread(self.sample_paths[index]))
        latent = read_latent(self.np_paths[index])
        if self.opt.get("color") == "y":
            from ssl_tpu_torch.utils.color_util import rgb2ycbcr
            lq, gt, sample = (rgb2ycbcr(v, y_only=True)[..., None] for v in (lq, gt, sample))
        return _tensors({"lq": self._norm(lq), "lq_path": self.lq_paths[index],
                         "gt": self._norm(gt), "gt_path": self.gt_paths[index],
                         "latent": latent, "latent_path": self.np_paths[index],
                         "sample": self._norm(sample),
                         "sample_path": self.sample_paths[index]})


def read_latent(path: str) -> np.ndarray:
    """A dumped latent as (h, w, c) float32: a leading batch axis is dropped,
    and a (c, h, w) one (c of 3 or 4, the reference's layout) transposed."""
    latent = np.load(path).astype(np.float32)
    if latent.ndim == 4:
        latent = latent[0]
    if latent.shape[0] in (3, 4) and latent.shape[-1] not in (3, 4):
        latent = latent.transpose(1, 2, 0)
    return latent
