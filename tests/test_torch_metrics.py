"""The port's PSNR/SSIM, Y channel and edge masks against ssl_tpu's on the
same seeded inputs.  Tolerances: the numpy metrics rtol 1e-10 (both float64;
the port sums the Gaussian window separably without cv2); the tensor
metrics rtol 1e-5 (both float32, convolutions in other orders); the Y
channel and the edge masks exactly."""

import numpy as np
import pytest
import torch

from ssl_tpu.metrics import calculate_metric as jax_calculate_metric
from ssl_tpu.metrics import psnr_ssim as jm
from ssl_tpu.ops import edge_mask as jem
from ssl_tpu.utils import color_util as jcu
from ssl_tpu_torch.metrics import calculate_metric
from ssl_tpu_torch.metrics import psnr_ssim as tm
from ssl_tpu_torch.ops import edge_mask as tem
from ssl_tpu_torch.utils import color_util as tcu


def _pair(h=45, w=38, seed=0, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(yy / 4.0) * 80, xx * 3.0, (yy + xx) * 2.0], -1) + 90
    a = np.clip(base + rng.randn(h, w, 3) * 5, 0, 255).round()
    b = np.clip(a + rng.randn(h, w, 3) * 12, 0, 255).round()
    return a.astype(dtype), b.astype(dtype)


@pytest.mark.parametrize("crop, y", [(0, False), (4, False), (4, True), (0, True)])
def test_psnr_ssim_match_jax(crop, y):
    for seed in range(2):
        a, b = _pair(seed=seed)
        for name in ("calculate_psnr", "calculate_ssim"):
            want = getattr(jm, name)(a, b, crop, test_y_channel=y)
            got = getattr(tm, name)(a, b, crop, test_y_channel=y)
            assert isinstance(got, float)
            np.testing.assert_allclose(got, want, rtol=1e-10, err_msg=name)
        chw = (a.transpose(2, 0, 1), b.transpose(2, 0, 1))
        np.testing.assert_allclose(tm.calculate_ssim(*chw, crop, "CHW", y),
                                   jm.calculate_ssim(*chw, crop, "CHW", y), rtol=1e-10)
    opt = {"type": "calculate_ssim", "crop_border": crop, "test_y_channel": y, "better": "higher"}
    np.testing.assert_allclose(calculate_metric({"img": a, "img2": b}, opt),
                               jax_calculate_metric({"img": a, "img2": b}, opt), rtol=1e-10)
    assert tm.calculate_psnr(a, a) == float("inf")


@pytest.mark.parametrize("crop, y", [(0, False), (4, True)])
def test_tensor_metrics_match_jax(crop, y):
    rng = np.random.RandomState(3)
    x = rng.rand(3, 3, 40, 33).astype(np.float32)
    x2 = np.clip(x + rng.randn(*x.shape).astype(np.float32) * 0.05, 0, 1)
    for name in ("calculate_psnr_pt", "calculate_ssim_pt"):
        want = np.asarray(getattr(jm, name)(x, x2, crop, y))
        got = getattr(tm, name)(torch.from_numpy(x), torch.from_numpy(x2), crop, y)
        assert got.shape == (3,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, err_msg=name)


def test_to_y_channel_and_ycbcr_match_jax():
    a, _ = _pair(seed=4)
    np.testing.assert_array_equal(tcu.to_y_channel(a), jcu.to_y_channel(a))
    np.testing.assert_array_equal(tcu.to_y_channel(a[..., :1]), jcu.to_y_channel(a[..., :1]))
    f = a.astype(np.float32) / 255.0
    for y_only in (False, True):
        np.testing.assert_array_equal(tcu.rgb2ycbcr(a, y_only), jcu.rgb2ycbcr(a, y_only))
        np.testing.assert_array_equal(tcu.rgb2ycbcr(f, y_only), jcu.rgb2ycbcr(f, y_only))
        np.testing.assert_array_equal(tcu.bgr2ycbcr(f, y_only), jcu.bgr2ycbcr(f, y_only))


def test_unported_metrics_raise(monkeypatch):
    """LPIPS, DISTS and NIQE were stubs that raised until the metric suite
    was ported; now each dispatches to its metric: NIQE scores (its
    parameters are in the repository), LPIPS and DISTS raise only for the
    weights that are not (tests/test_torch_metrics_suite.py holds all three
    against ssl_tpu)."""
    for var in ("LPIPS_ALEX_PTH", "DISTS_PTH"):
        monkeypatch.delenv(var, raising=False)
    a, b = _pair(h=112, w=112, seed=5)
    data = {"img": a, "img2": b, "device": "cpu"}
    niqe = calculate_metric(data, {"type": "calculate_niqe", "crop_border": 4})
    assert isinstance(niqe, float) and np.isfinite(niqe)
    for name in ("calculate_lpips", "calculate_dists"):
        with pytest.raises(FileNotFoundError, match="weights are not in the repository"):
            calculate_metric(data, {"type": name, "crop_border": 4})


def _edge_images(seed=0):
    """Smooth fields with flat blocks and sharp steps, in [0, 1], NHWC."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:41, 0:36] / 40.0
    imgs = []
    for i in range(3):
        base = np.stack([np.sin(6 * yy + i) * 0.3, xx * yy, np.cos(5 * xx)], -1) * 0.5 + 0.5
        base[8:20, 5 + i:18] = 0.95
        base[25:, 20:] = 0.05 * i
        imgs.append(base + rng.randn(41, 36, 3) * 0.02)
    return np.clip(np.stack(imgs), -0.1, 1.1).astype(np.float32)


@pytest.mark.parametrize("threshold", [5.0, 20.0])
def test_edge_mask_torch_equals_jax(threshold):
    img = _edge_images()
    want = np.asarray(jem.edge_mask_jax(img, threshold))
    got = tem.edge_mask_torch(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()), threshold)
    assert got.shape == (3, 1, 41, 36) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)
    assert 0.02 < want.mean() < 0.9


@pytest.mark.parametrize("kw", [{}, {"use_log": True, "log_sigma": 1.5},
                                {"use_log": True, "log_ksize": 5}, {"color_mode": "RGB"}])
def test_edge_mask_np_and_gray_match_jax(kw):
    img = _edge_images(seed=1)[0]
    np.testing.assert_array_equal(tem.rgb_to_gray_l(img), jem.rgb_to_gray_l(img))
    np.testing.assert_array_equal(tem.edge_mask_np(img, 20.0, **kw), jem.edge_mask_np(img, 20.0, **kw))
