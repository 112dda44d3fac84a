"""The port's on-card degradation pieces against ssl_tpu's, on the CPU.

Each piece on seeded numpy inputs: ``filter2d`` and ``usm_sharp`` (atol
4e-6: float32 sums of 441 and 2,601 taps of values up to 1, some weights
negative, taken in another order carry about sqrt(n) eps32 = 2.5e-6 and
6e-6; measured at most 1.01e-6 and 1.37e-6 on these inputs), the resize at
every bucket size of a 64^2 and a 48^2 base in the three modes and back to
the canvas (atol 1e-5: F.interpolate's taps against the JAX band matrices),
``diff_jpeg`` at sizes that are no multiple of 16 with per-item qualities
(atol 1e-4 outside the 8x8 / 16x16 blocks of a coefficient that lies within
1e-4 of a half-integer before rounding, where the rounding surrogate may
take either side: such ties are counted), Gaussian and Poisson noise on the
same draws, and the exact parts (the level count, the bucket table, the
up / down / keep mapping).

Then the whole ``degrade_two_stage`` with the JAX step's draws replayed
(``tests/torch_realesrgan_cases.py``), at the shipped probabilities, on
keys whose draws take Gaussian noise in both stages and on keys whose draws
take Poisson in both: each stage before the final rounding within atol 1e-4
of the same chain of JAX pieces; the port's output equal to its own chain
rounded; and against ``degrade_two_stage_jax`` at most one uint8 level on
at most 0.1% of the pixels, equal elsewhere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.ops import degrade_jax as dj
from ssl_tpu.ops import diffjpeg as jdiffjpeg
from ssl_tpu.ops.img_process import filter2d as jfilter2d
from ssl_tpu.ops.img_process import usm_sharp as jusm_sharp
from ssl_tpu.ops.torch_resize import interp_torch as jinterp
from ssl_tpu_torch.ops import degrade as td
from ssl_tpu_torch.ops.diffjpeg import diff_jpeg
from ssl_tpu_torch.ops.img_process import filter2d, usm_sharp
from ssl_tpu_torch.ops.torch_resize import MODES, interp_torch
from torch_realesrgan_cases import jax_draws, kernel_batch, nchw, nhwc

JAX_METHOD = {"area": "area", "bilinear": "linear", "bicubic": "cubic"}


def _close(got: torch.Tensor, want, atol):
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0, atol=atol)


def test_filter2d_and_usm_sharp_match_jax():
    batch = kernel_batch(2, 48, 0, mask=False)
    gt = jnp.asarray(batch["gt"])
    for k in ("kernel1", "kernel2", "sinc_kernel"):
        _close(filter2d(nchw(batch["gt"]), torch.from_numpy(batch[k])),
               jfilter2d(gt, jnp.asarray(batch[k])), 4e-6)
    sharp = usm_sharp(nchw(batch["gt"]))
    _close(sharp, jusm_sharp(gt), 4e-6)
    assert float((sharp - nchw(batch["gt"])).abs().max()) > 1e-2     # USM moved the edges


@pytest.mark.parametrize("base", [64, 48])
def test_resize_at_every_bucket_matches_jax(base):
    rng = np.random.RandomState(base)
    img = rng.rand(2, base, base, 3).astype(np.float32)
    canvas = base // 2
    sizes = set()
    for rrange in ((0.15, 1.5), (0.3, 1.2)):
        sizes.update(td.bucket_table(rrange, base, 7)[0])
    for size in sorted(sizes):
        for mode in MODES:
            mid = interp_torch(nchw(img), (size, size), mode)
            want_mid = jinterp(jnp.asarray(img), (size, size), mode)
            _close(mid, want_mid, 1e-5)
            _close(interp_torch(mid, (canvas, canvas), mode),
                   jinterp(want_mid, (canvas, canvas), mode), 1e-5)


def _jpeg_ties(img: np.ndarray, quality: np.ndarray) -> np.ndarray:
    """(b, h, w) pixels whose 8x8 luma block or 16x16 chroma block holds a
    coefficient within 1e-4 of a half-integer before the JAX rounding."""
    b, h, w, _ = img.shape
    ph, pw = (16 - h % 16) % 16, (16 - w % 16) % 16
    x = jnp.pad(jnp.asarray(img), ((0, 0), (0, ph), (0, pw), (0, 0))) * 255.0
    ycc = x @ jdiffjpeg._RGB2YCBCR + jdiffjpeg._YCBCR_SHIFT
    factor = np.asarray(jdiffjpeg.quality_to_factor(quality)).reshape(b, 1, 1, 1)
    hp, wp = h + ph, w + pw
    tied = np.zeros((b, hp, wp), bool)
    for c, table, sub in ((0, jdiffjpeg.Y_TABLE, 1), (1, jdiffjpeg.C_TABLE, 2),
                          (2, jdiffjpeg.C_TABLE, 2)):
        chan = ycc[..., c] if sub == 1 else jdiffjpeg._avg_pool2(ycc[..., c])
        coefs = np.asarray(jdiffjpeg._dct8x8(jdiffjpeg._blockify(chan - 128.0)))
        v = coefs / (table * factor)
        near = (np.abs(np.abs(v - np.floor(v)) - 0.5) < 1e-4).any(axis=(2, 3))
        nb = wp // (8 * sub)
        for i, j in zip(*np.nonzero(near)):
            r, q = divmod(j, nb)
            tied[i, r * 8 * sub:(r + 1) * 8 * sub, q * 8 * sub:(q + 1) * 8 * sub] = True
    return tied[:, :h, :w]


@pytest.mark.parametrize("h,w", [(40, 40), (24, 24), (56, 40)])
def test_diff_jpeg_matches_jax(h, w):
    rng = np.random.RandomState(h + w)
    img = rng.rand(3, h, w, 3).astype(np.float32)
    quality = np.array([31.5, 60.25, 94.0], np.float32)
    want = np.asarray(jdiffjpeg.diff_jpeg(jnp.asarray(img), jnp.asarray(quality)))
    got = nhwc(diff_jpeg(nchw(img), torch.from_numpy(quality)))
    assert got.shape == want.shape
    tied = _jpeg_ties(img, quality)
    off = (np.abs(got - want) > 1e-4).any(axis=-1)
    assert not (off & ~tied).any(), (int((off & ~tied).sum()), float(np.abs(got - want).max()))
    assert tied.mean() < 0.05, tied.mean()


def test_gaussian_noise_matches_jax_on_the_same_normals():
    rng = np.random.RandomState(1)
    img = rng.rand(3, 20, 20, 3).astype(np.float32)
    sigma = np.array([1.0, 12.5, 30.0], np.float32)
    gray = np.array([0.0, 1.0, 0.0], np.float32)
    normals = rng.randn(3, 20, 20, 3).astype(np.float32)
    normals_gray = rng.randn(1, 20, 20, 1).astype(np.float32)
    want = dj.apply_gaussian_noise_jax(jnp.asarray(img), jnp.asarray(sigma.reshape(3, 1, 1, 1)),
                                       jnp.asarray(gray.reshape(3, 1, 1, 1)),
                                       jnp.asarray(normals), jnp.asarray(normals_gray))
    got = td.apply_gaussian_noise(nchw(img), torch.from_numpy(sigma), torch.from_numpy(gray),
                                  nchw(normals), nchw(normals_gray))
    _close(got, want, 1e-6)


def test_poisson_noise_matches_jax_with_its_samples():
    rng = np.random.RandomState(2)
    img = rng.rand(3, 20, 20, 3).astype(np.float32)
    img[1] = np.round(img[1] * 4) / 4                    # few levels: small vals
    scale = np.array([0.05, 1.5, 3.0], np.float32)
    gray = np.array([1.0, 0.0, 1.0], np.float32)
    key = jax.random.PRNGKey(5)
    kg, kc = jax.random.split(key)
    want = dj.apply_poisson_noise_jax(key, jnp.asarray(img), jnp.asarray(scale.reshape(3, 1, 1, 1)),
                                      jnp.asarray(gray.reshape(3, 1, 1, 1)))
    rates = []

    def sample(rate, which):
        rates.append(which)
        k = kg if which == "gray" else kc
        return nchw(jax.random.poisson(k, jnp.asarray(nhwc(rate))).astype(jnp.float32))
    got = td.apply_poisson_noise(nchw(img), torch.from_numpy(scale), torch.from_numpy(gray),
                                 sample)
    assert rates == ["gray", "color"]
    _close(got, want, 1e-6)


def test_poisson_vals_bucket_table_and_mapping_are_exact():
    rng = np.random.RandomState(3)
    img = np.round(rng.rand(4, 12, 12, 3) * 255) / 255
    img[1] = np.round(img[1] * 3) / 3
    img[2] = 0.0
    img = img.astype(np.float32)
    want = np.asarray(dj._poisson_vals(jnp.asarray(img))).reshape(4)
    got = td.poisson_vals(nchw(img)).reshape(4).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(got[1:3]) == [4.0, 1.0]
    for rrange, base in (((0.15, 1.5), 400), ((0.3, 1.2), 100), ((0.15, 1.5), 32),
                         ((0.3, 1.2), 8)):
        scales = np.linspace(rrange[0], rrange[1], 7)
        assert td.bucket_table(rrange, base, 7) == (
            [max(16, int(round(s * base / 8)) * 8) for s in scales],
            int(np.argmin(np.abs(scales - 1.0))))
    assert td.bucket_table((0.15, 1.5), 400, 7) == ([64, 152, 240, 328, 416, 512, 600], 4)
    assert td.bucket_table((0.3, 1.2), 100, 7) == ([32, 48, 64, 72, 88, 104, 120], 5)
    for updown in range(3):                      # degrade_jax.py's jnp.where mapping
        for up_idx in range(4, 7):
            for down_idx in range(5):
                idx = jnp.where(updown == 0, up_idx, jnp.where(updown == 1, down_idx, 4))
                assert td.bucket_index(updown, up_idx, down_idx, 4) == int(idx)


def _jax_chain(batch, draws, cfg):
    """degrade_two_stage_jax's chosen branch, piece by piece (NHWC jnp):
    the values after each stage, before the final rounding last."""
    gt = jnp.asarray(batch["gt"])
    h = gt.shape[1]
    stages = []

    def stage(img, d, rrange, base, out, n):
        size = td.bucket_table(rrange, base, cfg.n_buckets)[0][d.bucket]
        method = JAX_METHOD[MODES[d.mode]]
        mid = dj._resize_to(img, size, method)
        if d.use_gauss:
            sh = (-1, 1, 1, 1)
            mid = dj.apply_gaussian_noise_jax(mid, d.sigma.numpy().reshape(sh),
                                              d.gray.numpy().reshape(sh),
                                              nhwc(d.normals), nhwc(d.normals_gray))
        else:
            def rate_sample(rate, which):
                return nhwc(draws.poisson(nchw(np.asarray(rate)), n, which))
            mid = _jax_poisson(mid, d, rate_sample)
        return dj._resize_to(mid, out, method)

    out = jfilter2d(gt, jnp.asarray(batch["kernel1"]))
    out = stage(out, draws.stage1, cfg.resize_range, h, h // 2, 1)
    stages.append(out)
    out = jdiffjpeg.diff_jpeg(jnp.clip(out, 0, 1), draws.jpeg1.numpy())
    stages.append(out)
    if draws.do_blur2:
        out = jfilter2d(out, jnp.asarray(batch["kernel2"]))
    t = h // cfg.scale
    out = stage(out, draws.stage2, cfg.resize_range2, t, t, 2)
    stages.append(out)
    sinc = jnp.asarray(batch["sinc_kernel"])
    q2 = draws.jpeg2.numpy()
    if draws.first_sinc:
        out = jdiffjpeg.diff_jpeg(jnp.clip(jfilter2d(out, sinc), 0, 1), q2)
    else:
        out = jfilter2d(jdiffjpeg.diff_jpeg(jnp.clip(out, 0, 1), q2), sinc)
    stages.append(out)
    return stages


def _jax_poisson(img, d, sample):
    """apply_poisson_noise_jax with its draws taken from ``sample``."""
    sh = (-1, 1, 1, 1)
    scale, gray = d.pscale.numpy().reshape(sh), d.gray.numpy().reshape(sh)
    img_gray = dj._round_uint8_grid(0.2989 * img[..., 0:1] + 0.587 * img[..., 1:2]
                                    + 0.114 * img[..., 2:3])
    vals_g = dj._poisson_vals(img_gray)
    noise_gray = sample(img_gray * vals_g, "gray") / vals_g - img_gray
    img_c = dj._round_uint8_grid(img)
    vals_c = dj._poisson_vals(img_c)
    noise = sample(img_c * vals_c, "color") / vals_c - img_c
    noise = noise * (1 - gray) + noise_gray * gray
    return jnp.clip(img + noise * scale, 0.0, 1.0)


def _port_chain(batch, draws, cfg):
    """The port's pieces in the same order (NCHW torch)."""
    tb = {k: nchw(v) if v.ndim == 4 else torch.from_numpy(v) for k, v in batch.items()}
    h = tb["gt"].shape[-1]
    stages = []
    out = filter2d(tb["gt"], tb["kernel1"])
    out = td._resize_stage(out, draws.stage1, cfg.resize_range, h, h // 2, cfg.n_buckets,
                           lambda r, w: draws.poisson(r, 1, w))
    stages.append(out)
    out = td._jpeg(out, draws.jpeg1)
    stages.append(out)
    if draws.do_blur2:
        out = filter2d(out, tb["kernel2"])
    t = h // cfg.scale
    out = td._resize_stage(out, draws.stage2, cfg.resize_range2, t, t, cfg.n_buckets,
                           lambda r, w: draws.poisson(r, 2, w))
    stages.append(out)
    if draws.first_sinc:
        out = td._jpeg(filter2d(out, tb["sinc_kernel"]), draws.jpeg2)
    else:
        out = filter2d(td._jpeg(out, draws.jpeg2), tb["sinc_kernel"])
    stages.append(out)
    return stages


@pytest.fixture(scope="module")
def composite_fn():
    """The JAX degradation at the shipped probabilities, jitted once for the
    module (one compile of every bucket's and mode's branch)."""
    cfg = dj.DegradeJaxConfig()
    return cfg, jax.jit(lambda k, g, a, b, c: dj.degrade_two_stage_jax(k, g, a, b, c, cfg))


@pytest.fixture(scope="module", params=["gaussian", "poisson"])
def composite(request, composite_fn):
    """Two batches of GT 64, batch 2, whose replayed draws take the noise
    family in both stages: the first two keys PRNGKey(0..39) that do (with
    Gaussian noise 1 and 4, with Poisson 0 and 2: between them up, down and
    keep, all three modes and both orders of the final sinc and JPEG)."""
    jcfg, fn = composite_fn
    gauss = request.param == "gaussian"
    runs = []
    for seed in range(40):
        key = jax.random.PRNGKey(seed)
        draws = jax_draws(key, jcfg, 2, 64)
        if not draws.stage1.use_gauss == draws.stage2.use_gauss == gauss:
            continue
        batch = kernel_batch(2, 64, seed, mask=False)
        want = np.asarray(fn(key, batch["gt"], batch["kernel1"], batch["kernel2"],
                             batch["sinc_kernel"]))
        runs.append((batch, draws, want))
        if len(runs) == 2:
            break
    return request.param, jcfg, td.DegradeConfig(), runs


def test_degrade_two_stage_matches_jax_under_replayed_draws(composite):
    family, jcfg, tcfg, runs = composite
    assert len(runs) == 2
    for batch, draws, want in runs:
        assert draws.stage1.use_gauss == draws.stage2.use_gauss == (family == "gaussian")
        for i, (got, ref) in enumerate(zip(_port_chain(batch, draws, tcfg),
                                           _jax_chain(batch, draws, jcfg))):
            np.testing.assert_allclose(nhwc(got), np.asarray(ref), rtol=0, atol=1e-4,
                                       err_msg=f"{family} stage {i}")
        tb = {k: nchw(v) if v.ndim == 4 else torch.from_numpy(v) for k, v in batch.items()}
        lq = td.degrade_two_stage(tb["gt"], tb["kernel1"], tb["kernel2"], tb["sinc_kernel"],
                                  tcfg, draws)
        assert tuple(lq.shape) == (2, 3, 16, 16)
        assert torch.equal(lq, td.round_uint8_grid(_port_chain(batch, draws, tcfg)[-1]))
        levels = np.abs(np.round(nhwc(lq) * 255) - np.round(want * 255))
        assert levels.max() <= 1 and (levels > 0).mean() <= 1e-3, (levels.max(),
                                                                  (levels > 0).mean())
