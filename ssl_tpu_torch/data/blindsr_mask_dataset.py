"""DatasetBlindSRMask, the KAIR/BSRGAN-SSL training dataset.

Counterpart of ``ssl_tpu/data/blindsr_mask_dataset.py`` (reference:
train_BSGRAN/data/dataset_blindsrmask.py): GT and its ``.mat`` edge mask are
cropped together to ``H_size`` (:62-67), flipped and rotated, then degraded
by the BSRGAN chain (``data/bsrgan_degradation.py``) into (L, H, mask) with
``H_size == lq_patchsize * sf``.  The test phase pairs each GT with its
MATLAB-bicubic downsample.  Items are CHW float32 tensors, as the port's
other datasets give them.

The crops, flips and the degradation draw from the process's ``random``
and ``np.random`` streams: in the
main process (``num_worker_per_gpu: 0``) the train CLI seeds them with the
manual seed, and the training state saves and restores them, so one seed
gives the JAX loader's batches and a resumed run those of a straight one;
in a loader worker ``data/loader.py::worker_init_fn`` seeds them with the
seed plus the worker's id."""

from __future__ import annotations

import os
import random

import numpy as np

from ssl_tpu_torch.data.bsrgan_degradation import degradation_bsrgan
from ssl_tpu_torch.data.data_util import paths_from_folder
from ssl_tpu_torch.data.paired_image_dataset import BaseDataset, _tensors, load_mask
from ssl_tpu_torch.data.transforms import augment
from ssl_tpu_torch.utils.img_util import _cv2, img2array, imread
from ssl_tpu_torch.utils.matlab_resize import imresize
from ssl_tpu_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class DatasetBlindSRMask(BaseDataset):

    def __init__(self, opt: dict):
        self.opt = opt
        self.scale = opt.get("scale", 4)
        self.h_size = opt.get("H_size", opt.get("gt_size", 256))
        self.lq_patchsize = self.h_size // self.scale
        self.paths = paths_from_folder(opt["dataroot_gt"] if "dataroot_gt" in opt
                                       else opt["dataroot_H"])
        self.mask_root = opt.get("dataroot_gt_mask") or opt.get("dataroot_mask")
        self.phase = opt.get("phase", "train")
        self.use_hflip = opt.get("use_hflip", True)
        self.use_rot = opt.get("use_rot", True)
        if self.phase == "train" and _cv2() is None:
            from ssl_tpu_torch import native
            native.build()          # once here, not in each loader worker

    def __getitem__(self, index):
        gt_path = self.paths[index]
        img_gt = img2array(imread(gt_path))
        base = os.path.splitext(os.path.basename(gt_path))[0]
        mask = None
        if self.mask_root:
            for ext in (".mat", ".npy", ".png"):
                cand = os.path.join(self.mask_root, base + ext)
                if os.path.exists(cand):
                    mask = load_mask(cand)[..., None]
                    break
            if mask is None:
                raise FileNotFoundError(f"no mask for {base} in {self.mask_root}")

        if self.phase == "train":
            h, w = img_gt.shape[:2]
            top = random.randint(0, max(h - self.h_size, 0))
            left = random.randint(0, max(w - self.h_size, 0))
            img_gt = img_gt[top:top + self.h_size, left:left + self.h_size]
            if mask is not None:
                mask = mask[top:top + self.h_size, left:left + self.h_size]
                img_gt, mask = augment([img_gt, mask], self.use_hflip, self.use_rot)
            else:
                img_gt = augment(img_gt, self.use_hflip, self.use_rot)
            out = degradation_bsrgan(img_gt, self.scale, self.lq_patchsize, mask=mask,
                                     rng=random, np_rng=np.random)
            if mask is not None:
                lq, hq, mask = out
                return _tensors({"lq": lq, "gt": hq, "gt_mask": mask, "gt_path": gt_path})
            lq, hq = out
            return _tensors({"lq": lq, "gt": hq, "gt_path": gt_path})
        lq = np.clip(imresize(img_gt, 1.0 / self.scale), 0, 1).astype(np.float32)
        return _tensors({"lq": lq, "gt": img_gt, "gt_path": gt_path})
