"""The port's host two-stage degrader (``ssl_tpu_torch/data/realesr_degradation.py``),
its host C++ (``ssl_tpu_torch/native``) and RealESRGAN-SSL's host mode,
against ``ssl_tpu`` on the CPU.

* One seed gives the JAX degrader's plan exactly (the same
  ``RandomState`` / ``random.Random`` draws in the same order).
* Under a frozen plan, with Poisson draws injected as in
  tests/test_degradation_parity.py, the LQ is within one uint8 level of
  JAX's on at most 0.1% of its values (``LEVEL_SHARE``), at scale 1 and 4:
  both end on uint8 levels, and the float32 filters, resizes and 8 x 8 DCTs
  sum in other orders, so a value (or a JPEG coefficient) within rounding
  of a half-integer may go the other way.
* The C++ ``filter2d`` and JPEG agree with their numpy plain versions and
  with ``ssl_tpu.native`` / ``cv2``: filter2d within 2e-6 (float32 sums of
  up to 441 taps in another order), the JPEG within 2e-3, the bound of
  tests/test_native.py (a coefficient at a rounding tie moves its block).
* ``usm_sharp_np`` (no ``cv2``) within 1e-5 of JAX's (``cv2.GaussianBlur``).
* The pool, the degrader's whole ``__call__`` (degrade, crop, pool) and
  RealESRGAN-SSL's ``prepare_batch`` in host mode give JAX's crops and
  pairs; the streams and pool survive the training state."""

import numpy as np
import pytest
import torch

from ssl_tpu import native as jnative
from ssl_tpu.data import realesr_degradation as J
from ssl_tpu.models.realesrganssl_model import RealESRGANSSLModel as JRealESRGANSSLModel
from ssl_tpu_torch import native
from ssl_tpu_torch.data import realesr_degradation as T
from ssl_tpu_torch.models import build_model
from torch_host_degrade_cases import check_levels, det_poisson, kernels, with_det_poisson
from torch_realesrgan_cases import QSIZE, train_opt


def equal_trees(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            equal_trees(a[k], b[k])
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), (a, b)


@pytest.mark.parametrize("scale,order,seed", [(4, "two", 0), (1, "two", 1), (4, "one", 2)])
def test_draw_plan_equals_jax(scale, order, seed):
    j = J.RealESRGANDegrader({}, scale=scale, queue_size=0, degradation_order=order, seed=seed)
    t = T.RealESRGANDegrader({}, scale=scale, queue_size=0, degradation_order=order, seed=seed)
    for b in (2, 3):
        equal_trees(t.draw_plan(b), j.draw_plan(b))
    assert j.rng.randn() == t.rng.randn() and j.pyrng.random() == t.pyrng.random()


@pytest.mark.parametrize("scale", [1, 4])
def test_degrade_batch_frozen_plan_within_one_level(scale):
    """tests/test_degradation_parity.py's frozen plan: Gaussian stage 1 with
    given fields, Poisson stage 2 with ``det_poisson``, sinc first."""
    rng = np.random.default_rng(7)
    b, h = 2, 64
    gt = np.clip(rng.random((b, h, h, 3)), 0, 1).astype(np.float32)
    k1, k2, sinc = kernels(b, 3)
    h1 = int(h * 0.5)
    plan = {
        "scale1": 0.5, "mode1": "bicubic",
        "noise1": {"use_gauss": True, "level": np.array([12.0, 25.0], np.float32),
                   "gray": np.array([1.0, 0.0], np.float32),
                   "normals": rng.standard_normal((b, h1, h1, 3)).astype(np.float32),
                   "normals_gray": rng.standard_normal((h1, h1)).astype(np.float32),
                   "poisson": None},
        "jpeg_q1": np.array([45.0, 80.0], np.float32), "second_blur": True,
        "scale2": 1.15, "mode2": "area",
        "noise2": {"use_gauss": False, "level": np.array([1.4, 0.3], np.float32),
                   "gray": np.array([0.0, 1.0], np.float32), "normals": None,
                   "normals_gray": None, "poisson": det_poisson},
        "sinc_first": True, "final_mode": "bilinear", "jpeg_q2": np.array([88.0, 35.0], np.float32)}
    want = J.RealESRGANDegrader({}, scale=scale, queue_size=0).degrade_batch(
        gt, k1, k2, sinc, plan=plan)
    got = T.RealESRGANDegrader({}, scale=scale, queue_size=0).degrade_batch(
        gt, k1, k2, sinc, plan=plan)
    assert got.shape == (b, h // scale, h // scale, 3)
    check_levels(got, want)


@pytest.mark.parametrize("shape,ks", [((2, 33, 37, 3), 21), ((2, 5, 4, 3), 21), ((1, 1, 9, 3), 7)])
def test_native_filter2d_matches_numpy_cv2_and_jax_native(shape, ks):
    """Sizes below the kernel's radius reflect more than once (reflect-101)."""
    rng = np.random.RandomState(2)
    imgs = rng.rand(*shape).astype(np.float32)
    k = np.zeros((shape[0], ks, ks), np.float32)
    k[:, 2:ks - 1, 1:] = rng.rand(shape[0], ks - 3, ks - 1)
    k /= k.sum(axis=(1, 2), keepdims=True)
    got = native.filter2d_batch(imgs, k)
    for i in range(shape[0]):
        for ref in (T.filter2d_np(imgs[i], k[i]), J.filter2d_np(imgs[i], k[i]),
                    jnative.filter2d(imgs[i], k[i])):
            np.testing.assert_allclose(got[i], ref, rtol=0, atol=2e-6)


def test_native_jpeg_matches_numpy_and_jax_native():
    rng = np.random.RandomState(0)
    imgs = rng.rand(3, 48, 40, 3).astype(np.float32)
    q = [30.0, 75.0, 95.0]
    got = native.jpeg_roundtrip_batch(imgs, q, n_threads=3)
    assert got.shape == imgs.shape
    for i in range(3):
        for ref in (T.jpeg_np(imgs[i], q[i]), J.jpeg_np(imgs[i], q[i]),
                    jnative.jpeg_roundtrip(imgs[i], q[i])):
            assert np.abs(got[i] - ref).max() < 2e-3
    assert np.array_equal(T.jpeg_np(imgs[1], q[1]), J.jpeg_np(imgs[1], q[1]))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output; the
    library goes under the build directory, named by the source's hash."""
    bad = tmp_path / "pipeline.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    assert native.library_path().parent == tmp_path / "_build"
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    monkeypatch.setenv("PATH", str(tmp_path))          # no g++ at all
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.build()


def test_usm_sharp_matches_jax():
    rng = np.random.RandomState(4)
    yy, xx = np.mgrid[0:56, 0:60] / 56
    img = np.stack([np.sin(6 * yy) * 0.3 + 0.5, xx * yy, np.cos(5 * xx) * 0.3 + 0.5], -1)
    img = np.clip(img + rng.randn(*img.shape) * 0.05, 0, 1).astype(np.float32)
    img[10:30, 12:40] = 0.9
    np.testing.assert_allclose(T.usm_sharp_np(img), J.usm_sharp_np(img), rtol=0, atol=1e-5)


def test_pool_matches_jax():
    """tests/test_degradation.py:57,196: pass-through while filling, then
    shuffled pairs that stay pairs; the same global numpy seed gives the
    same permutations."""
    jpool, tpool = J.TrainingPairPool(4), T.TrainingPairPool(4)
    outs = []
    for pool in (jpool, tpool):
        np.random.seed(5)
        outs.append([pool({"lq": np.full((2, 4, 4, 3), i, np.float32),
                           "gt": np.full((2, 8, 8, 3), i, np.float32),
                           "gt_mask": np.full((2, 8, 8, 1), i, np.float32)}) for i in range(5)])
    for j, t in zip(*outs):
        equal_trees(t, j)
    last = outs[1][-1]
    assert [float(x) for x in outs[1][0]["lq"][:, 0, 0, 0]] == [0.0, 0.0]
    for k in range(2):
        v = last["lq"][k, 0, 0, 0]
        assert last["gt"][k, 0, 0, 0] == v == last["gt_mask"][k, 0, 0, 0]
    with pytest.raises(ValueError, match="divisible"):
        T.TrainingPairPool(3)({"lq": np.zeros((2, 4, 4, 3), np.float32)})


def test_degrader_call_matches_jax_and_state_round_trip():
    """Degrade, crop to gt_size and pool (scale 4, queue 4, batch 2) twice
    under one seed: the crops and pairs equal JAX's, the LQ within one level;
    then the streams and the pool through ``get_state`` / ``set_state``."""
    k1, k2, sinc = kernels(2, 6)
    rng = np.random.RandomState(8)
    batch = {"gt": rng.rand(2, 48, 48, 3).astype(np.float32),
             "gt_mask": (rng.rand(2, 48, 48, 1) < 0.3).astype(np.float32),
             "kernel1": k1, "kernel2": k2, "sinc_kernel": sinc, "gt_size": 32}
    outs = []
    for mod in (J, T):
        d = with_det_poisson(mod.RealESRGANDegrader({}, scale=4, queue_size=4, seed=11))
        np.random.seed(0)
        outs.append([d(dict(batch)) for _ in range(3)])
    for j, t in zip(*outs):
        assert sorted(t) == ["gt", "gt_mask", "lq"] and t["gt"].shape == (2, 32, 32, 3)
        equal_trees({k: t[k] for k in ("gt", "gt_mask")}, {k: j[k] for k in ("gt", "gt_mask")})
        check_levels(t["lq"], j["lq"])
    state = d.get_state()
    again = T.RealESRGANDegrader({}, scale=4, queue_size=4, seed=0)
    again.set_state(state)
    assert again.rng.randn() == d.rng.randn() and again.pyrng.random() == d.pyrng.random()
    assert again.pool.ptr == d.pool.ptr == 4
    equal_trees(again.pool.buffers, d.pool.buffers)


def test_realesrgan_host_mode_prepare_batch_matches_jax(tmp_path):
    """``degradation_device: false``: the port's ``prepare_batch`` on the
    loader's CHW batch against JAX's on the same NHWC batch, both degraders
    seeded by ``manual_seed``; then the training state carries the streams
    and (with ``save_degradation_pool``) the pool into a fresh model."""
    opt = train_opt(degradation_device=False, save_degradation_pool=True, manual_seed=3)
    opt["train"].pop("perceptual_opt")
    # the JAX recipe's own _init_degrader and prepare_batch, without its nets
    jmodel = object.__new__(JRealESRGANSSLModel)
    jmodel.opt = opt
    jmodel._init_degrader(opt)
    tmodel = build_model(opt, device="cpu")
    for m in (jmodel.degrader, tmodel.degrader):
        with_det_poisson(m)
    k1, k2, sinc = kernels(2, 9)
    rng = np.random.RandomState(10)
    gt = rng.rand(2, 48, 48, 3).astype(np.float32)
    mask = (rng.rand(2, 48, 48, 1) < 0.3).astype(np.float32)
    for _ in range(QSIZE // 2 + 1):                    # fill the pool, then swap
        np.random.seed(1)
        want = jmodel.prepare_batch({"gt": gt, "gt_mask": mask, "kernel1": k1, "kernel2": k2,
                                     "sinc_kernel": sinc})
        np.random.seed(1)
        got = tmodel.prepare_batch({"gt": torch.from_numpy(gt.transpose(0, 3, 1, 2).copy()),
                                    "gt_mask": torch.from_numpy(mask.transpose(0, 3, 1, 2).copy()),
                                    "kernel1": torch.from_numpy(k1),
                                    "kernel2": torch.from_numpy(k2),
                                    "sinc_kernel": torch.from_numpy(sinc)})
        got = {k: v.numpy().transpose(0, 2, 3, 1) for k, v in got.items()}
        size = opt["datasets"]["train"]["gt_size"]
        assert got["gt"].shape == (2, size, size, 3) and got["lq"].shape == (2, size // 4,
                                                                              size // 4, 3)
        equal_trees({k: got[k] for k in ("gt", "gt_mask")}, {k: want[k] for k in ("gt", "gt_mask")})
        check_levels(got["lq"], want["lq"])
    state = tmodel.init_state(seed=0)
    tmodel.save_training_state(state, str(tmp_path), 0, 1)
    fresh = build_model(opt, device="cpu")
    fresh.load_training_state(fresh.init_state(seed=1), str(tmp_path), 1)
    assert fresh.degrader.pool.ptr == QSIZE
    equal_trees(fresh.degrader.pool.buffers, tmodel.degrader.pool.buffers)
    assert fresh.degrader.rng.randn() == tmodel.degrader.rng.randn()
    assert fresh.degrader.pyrng.random() == tmodel.degrader.pyrng.random()
