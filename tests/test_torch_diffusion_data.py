"""The diffusion tree's two-stage-degradation datasets of the port
(``ssl_tpu_torch/data/extra_datasets.py``) against ``ssl_tpu``'s on the CPU.

Under one ``random`` / ``np.random`` seed, ``TwoStageDegradationImgMaskDataset``
gives JAX's items exactly (crop, flip, mask, the three kernels) over two GT
roots and a face subset; ``TwoStageDegradationDF2KDataset`` gives JAX's GT
crops exactly and, with both degraders seeded alike and the Poisson draws
injected (tests/torch_host_degrade_cases.py), an LQ within one uint8
level of JAX's on at most 0.1% of its values."""

import os
import random

import cv2
import numpy as np
import pytest
from scipy.io import savemat

from ssl_tpu.data import build_dataset as jax_build_dataset
from ssl_tpu.data.realesr_degradation import RealESRGANDegrader as JDegrader
from ssl_tpu_torch.data import build_dataset
from ssl_tpu_torch.data.realesr_degradation import RealESRGANDegrader
from torch_host_degrade_cases import check_levels, with_det_poisson


def _write(folder, names, size, rng, mask_folder=None):
    os.makedirs(folder, exist_ok=True)
    for name in names:
        cv2.imwrite(os.path.join(folder, f"{name}.png"),
                    (rng.rand(size[0], size[1], 3) * 255).astype(np.uint8))
        if mask_folder:
            os.makedirs(mask_folder, exist_ok=True)
            savemat(os.path.join(mask_folder, f"{name}.mat"),
                    {"mat": (rng.rand(*size) < 0.2).astype(np.float64)})


def _items(ds, indices, seed):
    random.seed(seed)
    np.random.seed(seed)
    return [ds[i] for i in indices]


@pytest.mark.parametrize("name", ["TwoStageDegradationImgMaskDataset",
                                  "TwoStageDegradation_Img_Mask_Dataset"])
def test_img_mask_dataset_items_equal_jax(tmp_path, name):
    rng = np.random.RandomState(0)
    _write(tmp_path / "gt_a", ["a0", "a1"], (40, 36), rng, tmp_path / "mask_a")
    _write(tmp_path / "gt_b", ["b0"], (30, 44), rng, tmp_path / "mask_b")
    _write(tmp_path / "faces", ["f0", "f1", "f2"], (32, 32), rng, tmp_path / "mask_a")
    opt = {"type": name, "phase": "train", "crop_size": 32,
           "dataroot_gt": [str(tmp_path / "gt_a"), str(tmp_path / "gt_b")],
           "dataroot_gt_mask": [str(tmp_path / "mask_a"), str(tmp_path / "mask_b")],
           "face_gt_path": str(tmp_path / "faces"), "num_face": 2}
    jds, tds = jax_build_dataset(dict(opt)), build_dataset(dict(opt))
    assert len(tds) == len(jds) == 5 and tds.paths == jds.paths
    order = [4, 0, 2, 1, 3, 0]
    for j, t in zip(_items(jds, order, 3), _items(tds, order, 3)):
        assert t["gt_path"] == j["gt_path"]
        assert np.array_equal(t["gt"].numpy().transpose(1, 2, 0), j["gt"])
        assert np.array_equal(t["gt_mask"].numpy().transpose(1, 2, 0), j["gt_mask"])
        assert t["gt"].shape[1:] == (min(32, *j["gt"].shape[:2]),) * 2
        for k in ("kernel1", "kernel2", "sinc_kernel"):
            assert np.array_equal(t[k].numpy(), j[k]), k


def test_img_mask_dataset_needs_each_mask(tmp_path):
    rng = np.random.RandomState(1)
    _write(tmp_path / "gt", ["x"], (16, 16), rng)
    os.makedirs(tmp_path / "mask")
    ds = build_dataset({"type": "TwoStageDegradationImgMaskDataset", "crop_size": 16,
                        "dataroot_gt": str(tmp_path / "gt"),
                        "dataroot_gt_mask": str(tmp_path / "mask")})
    with pytest.raises(FileNotFoundError, match="mask for x"):
        ds[0]


@pytest.mark.parametrize("name", ["TwoStageDegradationDF2KDataset",
                                  "TwoStageDegradation_DF2K_Dataset"])
def test_df2k_dataset_items_equal_jax(tmp_path, name):
    rng = np.random.RandomState(2)
    _write(tmp_path / "gt", ["d0", "d1", "d2"], (48, 52), rng)
    opt = {"type": name, "phase": "train", "dataroot_gt": str(tmp_path / "gt"), "gt_size": 32,
           "scale": 4}
    jds, tds = jax_build_dataset(dict(opt)), build_dataset(dict(opt))
    jds.degrader = with_det_poisson(JDegrader(opt, scale=4, queue_size=0, seed=5))
    tds._degrader = with_det_poisson(RealESRGANDegrader(opt, scale=4, queue_size=0, seed=5))
    tds._pid = os.getpid()
    order = [2, 0, 1]
    for j, t in zip(_items(jds, order, 7), _items(tds, order, 7)):
        assert t["gt_path"] == j["gt_path"] and sorted(t) == sorted(j)
        assert np.array_equal(t["gt"].numpy().transpose(1, 2, 0), j["gt"])
        assert t["lq"].shape == (3, 8, 8)
        check_levels(t["lq"].numpy().transpose(1, 2, 0), j["lq"])
