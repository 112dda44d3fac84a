"""The port's BSRGAN degradation (``data/bsrgan_degradation.py``), its
MATLAB ``imresize`` and ``DatasetBlindSRMask`` against ssl_tpu's, on the
CPU.

* With ``cv2``: each op and the whole chain bit for bit, the port drawing
  from ``random.Random(seed)`` / ``np.random.RandomState(seed)`` and the JAX
  module from the global streams seeded alike.
* With ``cv2`` hidden (the port's own code): each resize mode within 1e-5
  of ``cv2.resize`` (OpenCV's vector paths fuse some multiply-adds; measured
  5e-7), the JPEG round trip within one uint8 level on at most 0.1% of the
  values at quality 75/85/95 (measured: equal), also at sizes that are not
  multiples of 16, and the chain within one level on at most 0.1% of the
  LQ values (its draws do not depend on the values: no Poisson noise in
  this chain).
* ``imresize`` within 1e-12 (float64, the same numpy code)."""

import random
import sys

import cv2
import numpy as np
import pytest
import torch

import ssl_tpu.data.bsrgan_degradation as J
import ssl_tpu_torch.data.bsrgan_degradation as T
from ssl_tpu.utils.matlab_resize import imresize as jimresize
from ssl_tpu_torch.utils.matlab_resize import imresize as timresize

SEEDS = range(6)
LEVEL_SHARE = 1e-3


def _gt(h=256, w=256, seed=7):
    yy, xx = np.mgrid[0:h, 0:w]
    rs = np.random.RandomState(seed)
    img = 0.5 + 0.3 * np.sin(yy[..., None] / 9.0 + np.arange(3)) * np.cos(xx[..., None] / 13.0)
    img[h // 4:h // 2, w // 3:w // 2] = 0.9
    return np.clip(img + 0.05 * rs.randn(h, w, 3), 0, 1).astype(np.float32)


def _gens(seed):
    random.seed(seed)
    np.random.seed(seed)
    return {"rng": random.Random(seed), "np_rng": np.random.RandomState(seed)}


def _levels_off(a, b):
    """Share of values more than half a uint8 level apart, and the largest
    difference in levels."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) * 255
    return float((d > 0.5).mean()), float(d.max())


OPS = {
    "add_blur": (lambda m, img, g: m.add_blur(img, 4, **({"rng": g["rng"]} if g else {}))),
    "add_resize": (lambda m, img, g: m.add_resize(img, 4, **(g or {}))),
    "add_gaussian_noise_bsr": (lambda m, img, g: m.add_gaussian_noise_bsr(img, 1, 12,
                                                                          **(g or {}))),
    "add_speckle_noise": (lambda m, img, g: m.add_speckle_noise(img, **(g or {}))),
    "add_poisson_noise_bsr": (lambda m, img, g: m.add_poisson_noise_bsr(img, **(g or {}))),
    "add_jpeg_noise": (lambda m, img, g: m.add_jpeg_noise(img, **({"rng": g["rng"]}
                                                                   if g else {}))),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_each_op_is_bit_equal_with_cv2(op):
    img = _gt(64, 72)
    for seed in SEEDS:
        gens = _gens(seed)
        want = OPS[op](J, img, None)
        got = OPS[op](T, img, gens)
        assert got.dtype == want.dtype and np.array_equal(got, want), (op, seed)
        # the port's generators advanced as the global streams did
        assert gens["rng"].random() == random.random()
        assert gens["np_rng"].rand() == np.random.rand()


def test_kernels_and_shift_are_the_jax_ones():
    for args in ((9, 0.3, 1.2, 0.4), (5, 2.0, 0.1, 1.6)):
        np.testing.assert_array_equal(T.anisotropic_gaussian_bsr(*args),
                                      J.anisotropic_gaussian_bsr(*args))
    k = T._fspecial_gaussian(7, 1.3)
    np.testing.assert_array_equal(k, J._fspecial_gaussian(7, 1.3))
    np.testing.assert_array_equal(T.shift_pixel(k, 3), J.shift_pixel(k, 3))


@pytest.mark.parametrize("seed", range(12))
def test_chain_is_bit_equal_with_cv2(seed):
    """The mask-aware chain (256^2 GT, LQ 64) and the no-crop chain: every
    branch (x2 pre-downsample, the shuffled order, both downsample2 modes,
    JPEG or not) is reached over the seeds."""
    gt = _gt()
    mask = (np.random.RandomState(seed).rand(256, 256, 1) > 0.7).astype(np.float32)
    gens = _gens(seed)
    want = J.degradation_bsrgan(gt, 4, 64, mask=mask)
    got = T.degradation_bsrgan(gt, 4, 64, mask=mask, **gens)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), seed
    assert got[0].shape == (64, 64, 3)
    gens = _gens(seed)
    want = J.degradation_bsrgan(gt[:200, :236], 4, 16, no_crop=True)
    got = T.degradation_bsrgan(gt[:200, :236], 4, 16, no_crop=True, **gens)
    assert got[0].shape == (50, 59, 3)
    for g, w in zip(got, want):
        assert np.array_equal(g, w), seed


def test_chain_checks_its_crop_invariant():
    gt = _gt(96, 96)
    with pytest.raises(ValueError, match="pre-cropped"):
        T.degradation_bsrgan(gt, 4, 16, mask=np.zeros((96, 96, 1), np.float32),
                             **_gens(0))
    with pytest.raises(ValueError, match="too small"):
        T.degradation_bsrgan(gt, 4, 32, **_gens(0))


RESIZES = [((256, 256), (232, 232)), ((256, 256), (128, 128)), ((256, 256), (64, 64)),
           ((217, 233), (58, 61)), ((217, 233), (197, 211)), ((64, 64), (64, 64)),
           ((37, 45), (80, 130)), ((100, 60), (25, 20))]


@pytest.mark.parametrize("mode", [T.INTER_LINEAR, T.INTER_CUBIC, T.INTER_AREA])
def test_resize_without_cv2_matches_cv2(mode, monkeypatch):
    rng = np.random.RandomState(mode)
    for src, dst in RESIZES:
        img = rng.rand(*src, 3).astype(np.float32)
        want = cv2.resize(img, dst[::-1], interpolation=mode)
        monkeypatch.setitem(sys.modules, "cv2", None)
        got = T.resize(img, dst[::-1], mode)
        monkeypatch.undo()
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=f"{src}->{dst}")


@pytest.mark.parametrize("quality", [75, 85, 95])
def test_jpeg_without_cv2_matches_cv2(quality, monkeypatch):
    rng = np.random.RandomState(quality)
    for h, w in ((64, 64), (61, 45), (37, 53), (17, 9), (100, 3)):
        img = np.uint8((_gt(h, w, quality) * 255).round())
        img = np.clip(img.astype(int) + rng.randint(-20, 21, img.shape), 0, 255).astype(np.uint8)
        want = cv2.cvtColor(cv2.imdecode(cv2.imencode(
            ".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
            [int(cv2.IMWRITE_JPEG_QUALITY), quality])[1], 1), cv2.COLOR_BGR2RGB)
        monkeypatch.setitem(sys.modules, "cv2", None)
        got = T.jpeg_roundtrip(img, quality)
        monkeypatch.undo()
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= LEVEL_SHARE, ((h, w), d.max(), (d > 0).mean())


@pytest.mark.parametrize("seed", SEEDS)
def test_chain_without_cv2_matches_jax(seed, monkeypatch):
    gt = _gt()
    mask = (np.random.RandomState(seed).rand(256, 256, 1) > 0.7).astype(np.float32)
    random.seed(seed)
    np.random.seed(seed)
    want = J.degradation_bsrgan(gt, 4, 64, mask=mask)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = T.degradation_bsrgan(gt, 4, 64, mask=mask, rng=random.Random(seed),
                               np_rng=np.random.RandomState(seed))
    share, worst = _levels_off(got[0], want[0])
    assert share <= LEVEL_SHARE and worst <= 1.0, (seed, share, worst)
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])


@pytest.mark.parametrize("scale", [0.5, 0.25, 1 / 3, 2.0])
def test_matlab_imresize_matches_jax(scale):
    img = _gt(48, 40).astype(np.float64)
    np.testing.assert_allclose(timresize(img, scale), jimresize(img, scale), rtol=0, atol=1e-12)


def _dataset_opt(d, phase):
    return {"name": "synth", "type": "DatasetBlindSRMask", "dataroot_gt": d["gt"],
            "dataroot_gt_mask": d["mask"], "H_size": 32, "scale": 4, "phase": phase}


@pytest.mark.parametrize("phase", ["train", "test"])
def test_dataset_items_match_jax(phase, tmp_path):
    """Four items of each package's DatasetBlindSRMask from one seed (the
    global streams in both): the crops, flips, degradation and mask of the
    train phase; the bicubic pairing of the test phase."""
    from ssl_tpu.data.blindsr_mask_dataset import DatasetBlindSRMask as JDataset
    from ssl_tpu_torch.data import build_dataset
    from torch_cli_cases import write_dataset
    d = write_dataset(str(tmp_path), n_train=2, gt=64)
    jset, tset = JDataset(_dataset_opt(d, phase)), build_dataset(_dataset_opt(d, phase))
    assert len(tset) == len(jset) == 2
    random.seed(3)
    np.random.seed(3)
    want = [jset[i % 2] for i in range(4)]
    random.seed(3)
    np.random.seed(3)
    got = [tset[i % 2] for i in range(4)]
    for g, w in zip(got, want):
        for k in ("lq", "gt", "gt_mask") if phase == "train" else ("lq", "gt"):
            assert torch.is_tensor(g[k]) and g[k].dim() == 3
            np.testing.assert_array_equal(g[k].numpy().transpose(1, 2, 0), w[k], err_msg=k)
        assert g["gt_path"] == w["gt_path"]
