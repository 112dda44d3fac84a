"""BSRGAN shuffled degradation chain (KAIR tree path).

Counterpart of ``ssl_tpu/data/bsrgan_degradation.py`` (reference:
train_BSGRAN/utils/utils_blindsr.py:443-530, degradation_bsrgan): an
optional x2 pre-downsample, a shuffled 7-op chain (blur x2, downsample2,
downsample3 kept after it, Gaussian noise, JPEG, the ISP draw) and a final
JPEG.  The mask-aware dataset crops GT and mask to ``H_size`` first, so the
trailing random crop is an identity exactly when ``H_size == lq_patchsize *
sf``; that invariant is checked here.

Each op draws from the generators it is given, ``rng`` (a ``random.Random``,
or the ``random`` module) and ``np_rng`` (a ``np.random.RandomState``, or
``np.random``), in exactly the order in which the JAX module draws from the
global streams, so under one seed both give the same output.

``cv2`` runs the resizes and the JPEG where it imports, as in the JAX
package.  Without it the port's own versions run: ``resize`` (OpenCV's
float32 resize: pixel-centre linear and cubic with A = -0.75 and clamped
borders, area as box sums at integer factors and area weights otherwise) and
``native.jpeg_libjpeg_roundtrip`` (libjpeg's encode and decode at cv2's
defaults, in its integer arithmetic)."""

from __future__ import annotations

import random

import numpy as np
from scipy import ndimage

from ssl_tpu_torch.utils.img_util import _cv2
from ssl_tpu_torch.utils.matlab_resize import imresize

INTER_LINEAR, INTER_CUBIC, INTER_AREA = 1, 2, 3


# ------------------------------------------------------------------ resize
def _cubic_coeffs(x: np.ndarray) -> np.ndarray:
    """OpenCV's interpolateCubic (A = -0.75) of the fractional positions
    ``x`` (float64), rounded to float32: (n,) -> (n, 4)."""
    a = -0.75
    x1, y = x + 1, 1 - x
    c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * y - (a + 3)) * y * y + 1
    return np.stack([c0, c1, c2, 1 - c0 - c1 - c2], axis=1).astype(np.float32)


def _taps(n_src: int, n_dst: int, mode: int, horizontal: bool):
    """Source indices (n_dst, k) and float32 weights (n_dst, k) of one axis,
    as OpenCV's generic resize computes them: ``scale = 1 / (n_dst /
    n_src)``, the source position (d + 0.5) scale - 0.5 and its fraction in
    float64 (INTER_AREA when upsampling: its bilinear emulation, whose
    fraction OpenCV rounds to float32 first), indices
    clamped to the axis; for linear the horizontal axis also clamps the
    position itself."""
    scale = 1.0 / (n_dst / n_src)
    d = np.arange(n_dst, dtype=np.float64)
    if mode == INTER_AREA:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * (n_dst / n_src)).astype(np.float32)   # float32 here
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float64)
    else:
        f = (d + 0.5) * scale - 0.5
        s = np.floor(f).astype(np.int64)
        f = f - s
    if mode == INTER_CUBIC:
        return np.clip(s[:, None] + np.arange(-1, 3), 0, n_src - 1), _cubic_coeffs(f)
    if horizontal:
        low, high = s < 0, s >= n_src - 1
        f = np.where(low | high, 0.0, f)
        s = np.where(low, 0, np.where(high, n_src - 1, s))
    idx = np.clip(s[:, None] + np.arange(2), 0, n_src - 1)
    return idx, np.stack([1 - f, f], axis=1).astype(np.float32)


def _area_taps(n_src: int, n_dst: int):
    """computeResizeAreaTab: per destination index its (source, weight)
    entries in order, as (n_dst, m) arrays padded with weight 0."""
    scale = 1.0 / (n_dst / n_src)
    rows = []
    for dx in range(n_dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_src - fsx1)
        sx2 = min(int(np.floor(fsx2)), n_src - 1)
        sx1 = min(int(np.ceil(fsx1)), sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        row += [(sx, np.float32(1.0 / cell)) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
        rows.append(row)
    m = max(len(r) for r in rows)
    idx = np.zeros((n_dst, m), np.int64)
    wgt = np.zeros((n_dst, m), np.float32)
    for dx, row in enumerate(rows):
        for j, (sx, a) in enumerate(row):
            idx[dx, j], wgt[dx, j] = sx, a
    return idx, wgt


def _resize_area(img: np.ndarray, w: int, h: int) -> np.ndarray:
    sh, sw = img.shape[:2]
    sx, sy = 1.0 / (w / sw), 1.0 / (h / sh)
    ix, iy = int(round(sx)), int(round(sy))
    eps = np.finfo(np.float64).eps
    if abs(sx - ix) < eps and abs(sy - iy) < eps:
        # resizeAreaFast_: the box summed row by row, four terms at a time
        box = img[: h * iy, : w * ix].reshape(h, iy, w, ix, -1)
        terms = [box[:, a, :, b] for a in range(iy) for b in range(ix)]
        total = np.zeros_like(terms[0])
        k = 0
        while k + 4 <= len(terms):
            total = total + (((terms[k] + terms[k + 1]) + terms[k + 2]) + terms[k + 3])
            k += 4
        for t in terms[k:]:
            total = total + t
        return (total * np.float32(1.0 / (ix * iy))).astype(np.float32)
    xi, xw = _area_taps(sw, w)
    yi, yw = _area_taps(sh, h)
    buf = np.zeros((sh, w, img.shape[2]), np.float32)
    for j in range(xi.shape[1]):
        buf = buf + img[:, xi[:, j]] * xw[:, j, None]
    out = buf[yi[:, 0]] * yw[:, 0, None, None]
    for j in range(1, yi.shape[1]):
        out = out + buf[yi[:, j]] * yw[:, j, None, None]
    return out.astype(np.float32)


def _cubic_taps_u8(n_src: int, n_dst: int):
    """One axis of OpenCV's 8-bit cubic resize: source indices (n_dst, 4),
    clamped to the axis, and 11-bit fixed-point weights (n_dst, 4): the
    position (d + 0.5) scale - 0.5 rounded to float32, its fraction and
    interpolateCubic in float32, each weight x 2048 rounded half to even."""
    f32 = np.float32
    d = np.arange(n_dst, dtype=np.float64)
    pos = ((d + 0.5) * (1.0 / (n_dst / n_src)) - 0.5).astype(f32)
    s = np.floor(pos).astype(np.int64)
    x = (pos - s.astype(f32)).astype(f32)
    a, one = f32(-0.75), f32(1)
    c0 = ((a * (x + one) - f32(5) * a) * (x + one) + f32(8) * a) * (x + one) - f32(4) * a
    c1 = ((a + f32(2)) * x - (a + f32(3))) * x * x + one
    c2 = ((a + f32(2)) * (one - x) - (a + f32(3))) * (one - x) * (one - x) + one
    c = np.stack([c0, c1, c2, one - c0 - c1 - c2], axis=1).astype(f32)
    return (np.clip(s[:, None] + np.arange(-1, 3), 0, n_src - 1),
            np.rint(c * f32(2048)).astype(np.int64))


def _resize_cubic_u8(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)`` of an (h,
    w, c) uint8 image: the horizontal pass in integers, the vertical one as
    OpenCV's vector loop computes it, fma(r0, b0, r1 b1) + fma(r2, b2, r3
    b3) in float32 with b = weight / 2^22, rounded half to even.  Equal to
    cv2 (5.0) bit for bit at the x2 and x4 of upscaling, whose weights are
    exact in 11 bits; at x3 cv2 rounds some values to the other neighbour."""
    xi, xa = _cubic_taps_u8(img.shape[1], w)
    yi, ya = _cubic_taps_u8(img.shape[0], h)
    src = img.astype(np.int64)
    rows = sum(src[:, xi[:, k]] * xa[:, k, None] for k in range(4)).astype(np.float32)
    b = (ya.astype(np.float32) * np.float32(2.0 ** -22))[:, :, None, None]

    def fma(r, bk, c):           # exact in float64 at these magnitudes, then one rounding
        return (r.astype(np.float64) * bk + c).astype(np.float32)
    out = fma(rows[yi[:, 0]], b[:, 0], rows[yi[:, 1]] * b[:, 1]) \
        + fma(rows[yi[:, 2]], b[:, 2], rows[yi[:, 3]] * b[:, 3])
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize(img: np.ndarray, dsize: tuple[int, int], interpolation: int) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=...)`` of an (h, w, c) float32
    image, dsize = (width, height): through cv2 where it imports, else
    OpenCV's float32 algorithm here (to float32 rounding: its vector paths
    fuse some multiply-adds).  A uint8 image takes INTER_CUBIC only
    (``_resize_cubic_u8``)."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, dsize, interpolation=interpolation)
    if img.dtype == np.uint8 and img.ndim == 3 and interpolation == INTER_CUBIC:
        return _resize_cubic_u8(img, *dsize)
    if img.dtype != np.float32 or img.ndim != 3:
        raise ValueError(f"expected an (h, w, c) float32 image, got {img.dtype} {img.shape}")
    w, h = dsize
    sh, sw = img.shape[:2]
    if (h, w) == (sh, sw):
        return img.copy()
    sx, sy = 1.0 / (w / sw), 1.0 / (h / sh)
    if interpolation == INTER_LINEAR and sx == 2 and sy == 2:
        interpolation = INTER_AREA          # cv::resize's exact x2 case
    if interpolation == INTER_AREA and sx >= 1 and sy >= 1:
        return _resize_area(img, w, h)
    if interpolation not in (INTER_LINEAR, INTER_CUBIC, INTER_AREA):
        raise ValueError(f"interpolation {interpolation} is not ported")
    xi, xw = _taps(sw, w, interpolation, True)
    yi, yw = _taps(sh, h, interpolation, False)
    rows = img[:, xi[:, 0]] * xw[:, 0, None]
    for k in range(1, xi.shape[1]):
        rows = rows + img[:, xi[:, k]] * xw[:, k, None]
    out = rows[yi[:, 0]] * yw[:, 0, None, None]
    for k in range(1, yi.shape[1]):
        out = out + rows[yi[:, k]] * yw[:, k, None, None]
    return out.astype(np.float32)


def jpeg_roundtrip(img_u8: np.ndarray, quality: int) -> np.ndarray:
    """(h, w, 3) RGB uint8 through cv2's JPEG encode and decode at
    ``quality`` (the port's libjpeg-exact C++ without cv2)."""
    cv2 = _cv2()
    if cv2 is None:
        from ssl_tpu_torch import native
        return native.jpeg_libjpeg_roundtrip(img_u8, quality)
    bgr = cv2.cvtColor(img_u8, cv2.COLOR_RGB2BGR)
    _, enc = cv2.imencode(".jpg", bgr, [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    return cv2.cvtColor(cv2.imdecode(enc, 1), cv2.COLOR_BGR2RGB)


# --------------------------------------------------------------------- ops
def _fspecial_gaussian(hsize: int, sigma: float) -> np.ndarray:
    """matlab fspecial('gaussian') (utils_blindsr.py:188-200), incl. the
    eps-threshold zeroing."""
    siz = (hsize - 1.0) / 2.0
    x, y = np.meshgrid(np.arange(-siz, siz + 1), np.arange(-siz, siz + 1))
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(float).eps * h.max()] = 0
    sumh = h.sum()
    if sumh != 0:
        h = h / sumh
    return h


def anisotropic_gaussian_bsr(ksize: int, theta: float, l1: float, l2: float) -> np.ndarray:
    """utils_blindsr.anisotropic_Gaussian (:64-96): eigenvalue-parameterized
    Gaussian evaluated on the gm_blur_kernel grid (center = size/2 - 1)."""
    v = np.array([np.cos(theta), np.sin(theta)])
    V = np.array([[v[0], v[1]], [v[1], -v[0]]])
    D = np.array([[l1, 0.0], [0.0, l2]])
    sigma = V @ D @ np.linalg.inv(V)
    inv = np.linalg.inv(sigma)
    center = ksize / 2.0 + 0.5
    ys, xs = np.mgrid[0:ksize, 0:ksize].astype(np.float64)
    cy = ys - center + 1
    cx = xs - center + 1
    quad = inv[0, 0] * cx * cx + (inv[0, 1] + inv[1, 0]) * cx * cy + inv[1, 1] * cy * cy
    k = np.exp(-0.5 * quad)
    return k / k.sum()


def shift_pixel(x: np.ndarray, sf: int, upper_left: bool = True) -> np.ndarray:
    """utils_blindsr.shift_pixel (:99-126): bilinear resample at +0.5*(sf-1),
    coordinates clipped to the image (scipy interp2d linear semantics)."""
    from scipy.interpolate import RegularGridInterpolator
    h, w = x.shape[:2]
    shift = (sf - 1) * 0.5
    xv, yv = np.arange(0, w, 1.0), np.arange(0, h, 1.0)
    x1 = xv + shift if upper_left else xv - shift
    y1 = yv + shift if upper_left else yv - shift
    x1 = np.clip(x1, 0, w - 1)
    y1 = np.clip(y1, 0, h - 1)
    interp = RegularGridInterpolator((yv, xv), x, method="linear")
    yy, xx = np.meshgrid(y1, x1, indexing="ij")
    return interp(np.stack([yy, xx], axis=-1))


def add_blur(img: np.ndarray, sf: int = 4, rng=random) -> np.ndarray:
    """utils_blindsr.add_blur (:335-346): 30% anisotropic (eigenvalues in
    [0, 0.2+0.2*sf]), else isotropic fspecial; ksize in {3,5,7,9};
    mirror-padded convolution."""
    wd2 = 0.2 + 0.2 * sf
    wd = 0.2 + 0.2 * sf
    if rng.random() < 0.3:
        l1 = wd2 * rng.random()
        l2 = wd2 * rng.random()
        k = anisotropic_gaussian_bsr(2 * rng.randint(0, 3) + 3, rng.random() * np.pi, l1, l2)
    else:
        k = _fspecial_gaussian(2 * rng.randint(0, 3) + 3, wd * rng.random())
    return ndimage.convolve(img, np.expand_dims(k, axis=2), mode="mirror")


def add_resize(img: np.ndarray, sf: int = 4, rng=random, np_rng=np.random) -> np.ndarray:
    """utils_blindsr.add_resize (:349-360)."""
    rnum = np_rng.rand()
    if rnum > 0.8:
        sf1 = rng.uniform(1, 2)
    elif rnum < 0.7:
        sf1 = rng.uniform(0.5 / sf, 1)
    else:
        sf1 = 1.0
    img = resize(img, (int(sf1 * img.shape[1]), int(sf1 * img.shape[0])), rng.choice([1, 2, 3]))
    return np.clip(img, 0.0, 1.0)


def _correlated_noise(img: np.ndarray, noise_level2: int, np_rng) -> np.ndarray:
    from scipy.linalg import orth
    L = noise_level2 / 255.0
    D = np.diag(np_rng.rand(3))
    U = orth(np_rng.rand(3, 3))
    conv = np.dot(np.dot(np.transpose(U), D), U)
    return np_rng.multivariate_normal([0, 0, 0], np.abs(L ** 2 * conv),
                                      img.shape[:2]).astype(np.float32)


def add_gaussian_noise_bsr(img: np.ndarray, noise_level1=1, noise_level2=12, rng=random,
                           np_rng=np.random) -> np.ndarray:
    """utils_blindsr.add_Gaussian_noise (:363-377): color (rnum>0.6) /
    grayscale (rnum<0.4) / correlated 3x3-covariance (else)."""
    noise_level = rng.randint(noise_level1, noise_level2)
    rnum = np_rng.rand()
    if rnum > 0.6:
        img = img + np_rng.normal(0, noise_level / 255.0, img.shape).astype(np.float32)
    elif rnum < 0.4:
        img = img + np_rng.normal(0, noise_level / 255.0, (*img.shape[:2], 1)).astype(np.float32)
    else:
        img = img + _correlated_noise(img, noise_level2, np_rng)
    return np.clip(img, 0.0, 1.0)


def add_speckle_noise(img: np.ndarray, noise_level1=2, noise_level2=25, rng=random,
                      np_rng=np.random) -> np.ndarray:
    """utils_blindsr.add_speckle_noise (:380-395): the multiplicative variant."""
    noise_level = rng.randint(noise_level1, noise_level2)
    img = np.clip(img, 0.0, 1.0)
    rnum = rng.random()
    if rnum > 0.6:
        img = img + img * np_rng.normal(0, noise_level / 255.0, img.shape).astype(np.float32)
    elif rnum < 0.4:
        img = img + img * np_rng.normal(0, noise_level / 255.0,
                                        (*img.shape[:2], 1)).astype(np.float32)
    else:
        img = img + img * _correlated_noise(img, noise_level2, np_rng)
    return np.clip(img, 0.0, 1.0)


def add_poisson_noise_bsr(img: np.ndarray, rng=random, np_rng=np.random) -> np.ndarray:
    """utils_blindsr.add_Poisson_noise (:398-409): uint8-rounded base,
    vals = 10^uniform[2,4], 50% full-color / 50% gray-only noise."""
    img = np.clip((img * 255.0).round(), 0, 255) / 255.0
    vals = 10 ** (2 * rng.random() + 2.0)
    if rng.random() < 0.5:
        img = np_rng.poisson(img * vals).astype(np.float32) / vals
    else:
        img_gray = np.dot(img[..., :3], [0.299, 0.587, 0.114])
        img_gray = np.clip((img_gray * 255.0).round(), 0, 255) / 255.0
        noise_gray = np_rng.poisson(img_gray * vals).astype(np.float32) / vals - img_gray
        img = img + noise_gray[:, :, np.newaxis]
    return np.clip(img, 0.0, 1.0)


def add_jpeg_noise(img: np.ndarray, rng=random) -> np.ndarray:
    """utils_blindsr.add_JPEG_noise (:412-418): quality in [75, 95]."""
    quality = rng.randint(75, 95)
    img_u8 = np.uint8((np.clip(img, 0, 1) * 255.0).round())
    return jpeg_roundtrip(img_u8, quality).astype(np.float32) / 255.0


def degradation_bsrgan(img: np.ndarray, sf: int = 4, lq_patchsize: int = 72,
                       mask: np.ndarray | None = None, no_crop: bool = False,
                       rng=random, np_rng=np.random):
    """Degrade an HWC [0,1] GT into (lq, hq[, mask]); the mask rides along
    with hq.  ``no_crop`` keeps the full image (offline test-set synthesis):
    the lq is resized to exactly (h//sf, w//sf) instead of patch-cropped.
    The op structure, probabilities and draw order are the JAX module's."""
    isp_prob, jpeg_prob, scale2_prob = 0.25, 0.9, 0.25
    sf_ori = sf
    h1, w1 = img.shape[:2]
    img = img.copy()[: h1 - h1 % sf, : w1 - w1 % sf, ...]
    h, w = img.shape[:2]
    if h < lq_patchsize * sf or w < lq_patchsize * sf:
        raise ValueError(f"img size ({h1}X{w1}) is too small!")
    hq = img.copy()
    if mask is not None:
        mask = mask[: h1 - h1 % sf, : w1 - w1 % sf, ...]
        if h != lq_patchsize * sf or w != lq_patchsize * sf:
            raise ValueError("mask-aware BSRGAN degradation requires pre-cropped GT "
                             "(H_size == lq_patchsize*sf) so the final crop is identity")

    if sf == 4 and rng.random() < scale2_prob:
        if np_rng.rand() < 0.5:
            img = resize(img, (int(1 / 2 * img.shape[1]), int(1 / 2 * img.shape[0])),
                         rng.choice([1, 2, 3]))
        else:
            img = imresize(img, 0.5)
        img = np.clip(img, 0.0, 1.0).astype(np.float32)
        sf = 2

    order = rng.sample(range(7), 7)
    i2, i3 = order.index(2), order.index(3)
    if i2 > i3:  # keep downsample3 after downsample2
        order[i2], order[i3] = order[i3], order[i2]

    a, b = img.shape[1], img.shape[0]
    for i in order:
        if i in (0, 1):
            img = add_blur(img, sf=sf, rng=rng)
        elif i == 2:
            a, b = img.shape[1], img.shape[0]
            if rng.random() < 0.75:
                sf1 = rng.uniform(1, 1 / 0.85)
                img = resize(img, (int(1 / sf1 * img.shape[1]), int(1 / sf1 * img.shape[0])),
                             rng.choice([1, 2, 3]))
            else:
                k = _fspecial_gaussian(2 * rng.randint(0, 3) + 3, rng.uniform(0.1, 0.25 * sf))
                k_shifted = shift_pixel(k, sf)
                k_shifted = k_shifted / k_shifted.sum()
                img = ndimage.convolve(img, np.expand_dims(k_shifted, axis=2), mode="mirror")
                img = img[0::sf, 0::sf, ...]
            img = np.clip(img, 0.0, 1.0).astype(np.float32)
        elif i == 3:
            img = resize(img, (int(1 / sf * a), int(1 / sf * b)), rng.choice([1, 2, 3]))
            img = np.clip(img, 0.0, 1.0).astype(np.float32)
        elif i == 4:
            img = add_gaussian_noise_bsr(img, 1, 12, rng=rng, np_rng=np_rng)
        elif i == 5:
            if rng.random() < jpeg_prob:
                img = add_jpeg_noise(img, rng=rng)
        elif i == 6:
            # camera ISP model: the reference consumes the probability draw
            # even with isp_model=None (short-circuit AND, :521)
            rng.random()

    img = add_jpeg_noise(img, rng=rng)

    if no_crop:
        target = (w // sf_ori, h // sf_ori)
        if img.shape[:2] != (target[1], target[0]):
            img = np.clip(resize(img, target, INTER_CUBIC), 0, 1).astype(np.float32)
        if mask is not None:
            return img.astype(np.float32), hq.astype(np.float32), mask
        return img.astype(np.float32), hq.astype(np.float32)

    # final crop (identity in the mask-aware path; random otherwise)
    lh, lw = img.shape[:2]
    if lh > lq_patchsize or lw > lq_patchsize:
        top = rng.randint(0, lh - lq_patchsize)
        left = rng.randint(0, lw - lq_patchsize)
        img = img[top:top + lq_patchsize, left:left + lq_patchsize]
        hq = hq[top * sf_ori:(top + lq_patchsize) * sf_ori,
                left * sf_ori:(left + lq_patchsize) * sf_ori]
        if mask is not None:
            mask = mask[top * sf_ori:(top + lq_patchsize) * sf_ori,
                        left * sf_ori:(left + lq_patchsize) * sf_ori]
    # guarantee exact lq size (interp rounding can drift a pixel)
    if img.shape[:2] != (lq_patchsize, lq_patchsize):
        img = resize(img, (lq_patchsize, lq_patchsize), INTER_CUBIC)
        img = np.clip(img, 0, 1).astype(np.float32)
    if mask is not None:
        return img.astype(np.float32), hq.astype(np.float32), mask
    return img.astype(np.float32), hq.astype(np.float32)
