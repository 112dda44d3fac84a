"""The port's RealESRGAN data side against ssl_tpu's, on the CPU: the
per-item kernel synthesis bit for bit under the same seeds, the dataset
items of ``MyRealESRGANImageMaskDataset`` and ``MultiLROneGTDataset`` equal
to the JAX package's (the same draws on the global ``random`` and
``np.random``), and the torch ``generate_mask`` entry point's files equal
to ``scripts/data_preparation/generate_mask.py``'s in both modes."""

import os
import random
import runpy
import sys

import cv2
import numpy as np
import pytest
import torch
from scipy.io import loadmat, savemat

from ssl_tpu.data import build_dataset as jax_build_dataset
from ssl_tpu.data.realesrgan_dataset import _KernelSynth as JaxKernelSynth
from ssl_tpu_torch.data import build_dataset
from ssl_tpu_torch.data.realesrgan_dataset import _KernelSynth
from ssl_tpu_torch.ops.edge_mask import edge_mask_np
from ssl_tpu_torch.scripts import generate_mask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH_OPT = {"sinc_prob": 0.3, "sinc_prob2": 0.3, "final_sinc_prob": 0.6,
             "blur_sigma": [0.2, 3], "blur_sigma2": [0.2, 1.5]}


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _picture(h, w, rng):
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([np.sin(7 * yy) * 0.3 + 0.5, xx * yy + 0.2, np.cos(5 * (xx + yy)) * 0.3 + 0.5],
                   -1) + rng.randn(h, w, 3) * 0.03
    img[h // 5:h // 2, w // 4:w // 2] = 0.9
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """gt/ (4 PNGs of 64 x 48), mask/ (.mat of the Laplacian > 20), and a
    BlindLR-style lq/ with two variant folders of LQ at x1/4 (the second
    holds only two of the four)."""
    root = tmp_path_factory.mktemp("realesrgan_data")
    d = {k: str(root / k) for k in ("gt", "mask", "lq")}
    for p in d.values():
        os.makedirs(p)
    rng = np.random.RandomState(0)
    for i in range(4):
        img = _picture(64, 48, rng)
        cv2.imwrite(os.path.join(d["gt"], f"im{i}.png"), img)
        savemat(os.path.join(d["mask"], f"im{i}.mat"),
                {"mat": edge_mask_np(img[..., ::-1], 20.0).astype(np.float64)})
        for variant, keep in (("blur_jpeg", True), ("noise", i < 2)):
            if keep:
                os.makedirs(os.path.join(d["lq"], variant), exist_ok=True)
                lq = cv2.resize(img, (12, 16), interpolation=cv2.INTER_AREA)
                cv2.imwrite(os.path.join(d["lq"], variant, f"im{i}.png"), lq)
    return d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_synthesis_is_bit_for_bit(seed):
    kinds = set()
    _seed(seed)
    want = [JaxKernelSynth(SYNTH_OPT).sample() for _ in range(40)]
    after_jax = (random.random(), np.random.rand())
    _seed(seed)
    got = [_KernelSynth(SYNTH_OPT).sample() for _ in range(40)]
    assert (random.random(), np.random.rand()) == after_jax     # the same draws, in order
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (21, 21)
            np.testing.assert_array_equal(a, b)
        kinds.add(bool((g[2] == 0).sum() == 21 * 21 - 1))          # pulse or sinc
    assert kinds == {True, False}


def test_realesrgan_mask_dataset_items_equal_jax(folders):
    opt = {"name": "t", "type": "MyRealESRGANImageMaskDataset", "dataroot_gt": folders["gt"],
           "dataroot_gt_mask": folders["mask"], "crop_pre": 40, "use_hflip": True,
           "use_rot": True, **SYNTH_OPT}
    jset, tset = jax_build_dataset(dict(opt)), build_dataset(dict(opt))
    assert len(jset) == len(tset) == 4
    _seed(5)
    want = [jset[i] for i in (0, 1, 2, 3, 1)]
    _seed(5)
    got = [tset[i] for i in (0, 1, 2, 3, 1)]
    for w, g in zip(want, got):
        assert g["gt_path"] == w["gt_path"]
        assert tuple(g["gt"].shape) == (3, 40, 40) and tuple(g["gt_mask"].shape) == (1, 40, 40)
        assert g["gt"].dtype == g["gt_mask"].dtype == torch.float32
        np.testing.assert_array_equal(g["gt"].numpy().transpose(1, 2, 0), w["gt"])
        np.testing.assert_array_equal(g["gt_mask"].numpy().transpose(1, 2, 0), w["gt_mask"])
        for k in ("kernel1", "kernel2", "sinc_kernel"):
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    assert float(got[0]["gt_mask"].sum()) > 0


def test_multi_lr_one_gt_dataset_items_equal_jax(folders):
    opt = {"name": "blind", "type": "MultiLROneGTDataset", "dataroot_gt": folders["gt"],
           "dataroot_lq": folders["lq"], "phase": "test", "scale": 4}
    jset, tset = jax_build_dataset(dict(opt)), build_dataset(dict(opt))
    assert len(jset) == len(tset) == 6
    for i in range(6):
        w, g = jset[i], tset[i]
        assert {k: g[k] for k in ("lq_path", "gt_path", "variant")} == \
            {k: w[k] for k in ("lq_path", "gt_path", "variant")}
        np.testing.assert_array_equal(g["lq"].numpy().transpose(1, 2, 0), w["lq"])
        np.testing.assert_array_equal(g["gt"].numpy().transpose(1, 2, 0), w["gt"])
        assert tuple(g["gt"].shape) == (3, 64, 48)


def _run_jax_script(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["generate_mask.py"] + argv)
    runpy.run_path(os.path.join(REPO, "scripts", "data_preparation", "generate_mask.py"),
                   run_name="__main__")


def _files(root):
    return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root)
                  for f in fs)


@pytest.mark.parametrize("mode", ["Laplacian", "LoG"])
def test_generate_mask_writes_the_jax_scripts_files(folders, tmp_path, monkeypatch, mode):
    args = ["--input", folders["gt"], "--threshold", "20", "--mode", mode]
    _run_jax_script(args + ["--output", str(tmp_path / "jax")], monkeypatch)
    monkeypatch.undo()
    mat_dir = generate_mask.main(args + ["--output", str(tmp_path / "torch")])
    assert mat_dir == str(tmp_path / "torch" / mode / "L" / "threshold-20.0" / "mat")
    want_root, got_root = tmp_path / "jax", tmp_path / "torch"
    assert _files(got_root) == _files(want_root)
    for f in _files(want_root):
        if f.endswith(".mat"):
            np.testing.assert_array_equal(loadmat(got_root / f)["mat"], loadmat(want_root / f)["mat"])
        elif f.endswith(".png"):
            np.testing.assert_array_equal(cv2.imread(str(got_root / f), cv2.IMREAD_UNCHANGED),
                                          cv2.imread(str(want_root / f), cv2.IMREAD_UNCHANGED))
        else:
            assert (got_root / f).read_text() == (want_root / f).read_text()


def test_generate_mask_without_cv2(folders, tmp_path, monkeypatch):
    """Without cv2: Laplacian L masks from edge_mask_torch, equal to the JAX
    script's away from the one-pixel border, PNG through utils/png.py; LoG
    raises."""
    args = ["--input", folders["gt"], "--threshold", "20"]
    _run_jax_script(args + ["--output", str(tmp_path / "jax")], monkeypatch)
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "cv2", None)
    generate_mask.main(args + ["--output", str(tmp_path / "torch")])
    with pytest.raises(ImportError, match="needs cv2"):
        generate_mask.main(args + ["--output", str(tmp_path / "log"), "--mode", "LoG"])
    monkeypatch.undo()
    tag = os.path.join("Laplacian", "L", "threshold-20.0")
    for i in range(4):
        got = loadmat(tmp_path / "torch" / tag / "mat" / f"im{i}.mat")["mat"]
        want = loadmat(tmp_path / "jax" / tag / "mat" / f"im{i}.mat")["mat"]
        np.testing.assert_array_equal(got[1:-1, 1:-1], want[1:-1, 1:-1])
        png = cv2.imread(str(tmp_path / "torch" / tag / "png" / f"im{i}.png"),
                         cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(png, (got * 255).astype(np.uint8))
