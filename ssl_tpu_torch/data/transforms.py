"""CPU-side augmentation transforms (reference: data/transforms.py).

Counterpart of ``ssl_tpu/data/transforms.py``: numpy HWC images, the same
``rng`` argument (``random`` when None) and the same order of draws, so one
seed gives the same crops and flips in both packages."""

from __future__ import annotations

import random

import numpy as np


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale, ...]


def paired_random_crop(img_gts, img_lqs, gt_patch_size, scale, rng=None):
    """Random aligned crop: LQ gets gt_patch_size//scale (reference :10-90)."""
    return paired_random_crop_img_mask(img_gts, img_lqs, None, gt_patch_size, scale, rng)


def paired_random_crop_img_mask(img_gts, img_lqs, img_masks, gt_patch_size, scale, rng=None):
    """Aligned crop of GT + LQ + full-resolution edge mask (reference :93-151);
    with ``img_masks`` None it returns (gt, lq) only.  Each argument is an
    image or a list of images, and comes back the same way."""
    rng = rng or random
    gts, lqs, masks = ([] if x is None else x if isinstance(x, list) else [x]
                       for x in (img_gts, img_lqs, img_masks))
    h_lq, w_lq = lqs[0].shape[:2]
    h_gt, w_gt = gts[0].shape[:2]
    lq_patch_size = gt_patch_size // scale
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(f"Scale mismatches. GT ({h_gt}, {w_gt}) is not {scale}x of LQ ({h_lq}, {w_lq}).")
    if h_lq < lq_patch_size or w_lq < lq_patch_size:
        raise ValueError(f"LQ ({h_lq}, {w_lq}) is smaller than patch size ({lq_patch_size}, {lq_patch_size}).")
    top = rng.randint(0, h_lq - lq_patch_size)
    left = rng.randint(0, w_lq - lq_patch_size)
    top_gt, left_gt = top * scale, left * scale
    lqs = [v[top:top + lq_patch_size, left:left + lq_patch_size, ...] for v in lqs]
    gts, masks = ([v[top_gt:top_gt + gt_patch_size, left_gt:left_gt + gt_patch_size, ...]
                   for v in group] for group in (gts, masks))

    def like(orig, new):
        return new if isinstance(orig, list) else new[0]
    out = (like(img_gts, gts), like(img_lqs, lqs))
    return out if img_masks is None else out + (like(img_masks, masks),)


def augment(imgs, hflip=True, rotation=True, flows=None, return_status=False, rng=None):
    """Horizontal flip + 90-degree rotation augmentation (reference :154-240).

    vflip+transpose composition == rot90, matching the reference's scheme."""
    rng = rng or random
    hflip = hflip and rng.random() < 0.5
    vflip = rotation and rng.random() < 0.5
    rot90 = rotation and rng.random() < 0.5

    def _augment(img):
        if hflip:
            img = img[:, ::-1, ...]
        if vflip:
            img = img[::-1, :, ...]
        if rot90:
            img = img.transpose(1, 0, 2) if img.ndim == 3 else img.T
        return np.ascontiguousarray(img)

    single = not isinstance(imgs, list)
    if single:
        imgs = [imgs]
    imgs = [_augment(v) for v in imgs]
    if single:
        imgs = imgs[0]
    if return_status:
        return imgs, (hflip, vflip, rot90)
    return imgs
