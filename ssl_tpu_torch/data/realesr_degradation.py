"""Host-side Real-ESRGAN two-stage degradation (numpy, torch on the CPU and
the port's host C++).

Counterpart of ``ssl_tpu/data/realesr_degradation.py``: per-batch draws
(resize scale and mode, noise family, order of the last two ops) and
per-item blur kernels and JPEG qualities, the shuffled training-pair pool,
and USM sharpening, for the recipes that degrade on the host (the diffusion
training CLI; RealESRGAN-SSL with ``degradation_device: false``).

The draws come from ``np.random.RandomState(seed)`` and
``random.Random(seed)`` in the JAX degrader's order (``draw_plan`` is the
seam that freezes them), so one seed gives the JAX degrader's plan, noise
fields and Poisson draws.  The pixel work differs only in its arithmetic's
order: ``filter2d`` and the JPEG round trip run in ``ssl_tpu_torch/native``
(the JAX package filters with ``cv2``, which the port does not need), the
resizes are ``F.interpolate`` on CPU tensors (area, bilinear or bicubic,
``align_corners=False``, no antialias, a scale factor that floors).  The
numpy ``filter2d_np`` and ``jpeg_np`` are their plain versions.  Images are
numpy (b, h, w, 3) RGB float32 in [0, 1], as in the JAX package."""

from __future__ import annotations

import random as pyrandom
import time
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F

from ssl_tpu_torch import native
from ssl_tpu_torch.data.transforms import paired_random_crop_img_mask
from ssl_tpu_torch.ops.diffjpeg import _RGB2YCBCR, _YCBCR2RGB, C_TABLE, Y_TABLE, _dct_matrix

_DCT_NP = _dct_matrix()


def filter2d_np(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Plain version of the host C++ ``filter2d``: one (h, w, c) image
    correlated with a (k, k) kernel over a reflect-101 border (numpy's
    ``reflect`` pad), summed in float64."""
    k = kernel.shape[0]
    half = k // 2
    pad = np.pad(img.astype(np.float64), ((half, half), (half, half), (0, 0)), mode="reflect")
    h, w = img.shape[:2]
    out = np.zeros((h, w, img.shape[2]), np.float64)
    for ky in range(k):
        for kx in range(k):
            if kernel[ky, kx] != 0:
                out += float(kernel[ky, kx]) * pad[ky:ky + h, kx:kx + w]
    return out.astype(np.float32)


def _gaussian_kernel1d(ksize: int) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, 0)``: sigma 0.3 ((ksize - 1) / 2 - 1) + 0.8."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) * 0.5
    g = np.exp(-0.5 * x * x / (sigma * sigma))
    return g / g.sum()


def _gaussian_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), 0)`` of an (h, w[, c]) image:
    the separable kernel over a reflect-101 border, rows then columns."""
    g = _gaussian_kernel1d(ksize)
    half = ksize // 2
    x = img.astype(np.float64)
    for axis in (1, 0):
        widths = [(0, 0)] * x.ndim
        widths[axis] = (half, half)
        pad = np.pad(x, widths, mode="reflect")
        n = x.shape[axis]
        x = sum(g[i] * np.take(pad, np.arange(i, i + n), axis=axis) for i in range(ksize))
    return x.astype(np.float32)


def usm_sharp_np(img: np.ndarray, weight: float = 0.5, radius: int = 50,
                 threshold: int = 10) -> np.ndarray:
    """Unsharp masking of one (h, w, 3) image (reference
    utils/img_process_util.py:34-84), with ``cv2``'s Gaussian blur for
    ``radius`` (made odd) and sigma 0."""
    if radius % 2 == 0:
        radius += 1
    blur = _gaussian_blur(img, radius)
    residual = img - blur
    mask = (np.abs(residual) * 255 > threshold).astype(np.float32)
    soft_mask = _gaussian_blur(mask, radius)
    sharp = np.clip(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img


def _resize(imgs: np.ndarray, size_or_scale, mode: str) -> np.ndarray:
    """``F.interpolate`` of a (b, h, w, c) batch on the CPU: to a (h, w)
    size, or by a scale factor (size floor(dim * scale), the factor itself
    mapping the coordinates), area / bilinear / bicubic with
    ``align_corners=False`` and no antialias; a size equal to the input's
    returns the input."""
    if isinstance(size_or_scale, tuple) and tuple(size_or_scale) == imgs.shape[1:3]:
        return imgs
    x = torch.from_numpy(np.ascontiguousarray(imgs.transpose(0, 3, 1, 2), np.float32))
    kw = {"mode": mode} if mode == "area" else {"mode": mode, "align_corners": False}
    if isinstance(size_or_scale, tuple):
        out = F.interpolate(x, size=size_or_scale, **kw)
    else:
        out = F.interpolate(x, scale_factor=float(size_or_scale), **kw)
    return out.permute(0, 2, 3, 1).numpy()


def _rgb_to_grayscale(img: np.ndarray) -> np.ndarray:
    """torchvision's rgb_to_grayscale weights (the reference's Poisson gray
    path: 0.2989, not cv2's 0.299)."""
    return (0.2989 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])[..., None]


def _round_uint8_grid(img: np.ndarray) -> np.ndarray:
    return np.clip((img * 255.0).round(), 0, 255).astype(np.float32) / 255.0


def _poisson_vals(img_rounded: np.ndarray) -> float:
    """2 ** ceil(log2(number of distinct uint8 levels)) of one rounded image."""
    flat = (img_rounded * 255.0).round().astype(np.uint8).reshape(-1)
    n_levels = int((np.bincount(flat, minlength=256) > 0).sum())
    return float(2.0 ** np.ceil(np.log2(max(n_levels, 1))))


def apply_gaussian_noise_batch(out: np.ndarray, sigma: np.ndarray, gray: np.ndarray,
                               normals_color: np.ndarray,
                               normals_gray: np.ndarray | None) -> np.ndarray:
    """random_add_gaussian_noise_pt given its draws: per-item sigma and gray
    flag (b,), a colour field (b, h, w, 3) and one gray field (h, w) shared
    by the batch (the reference's broadcast); clipped, not rounded."""
    sigma = sigma.reshape(-1, 1, 1, 1).astype(np.float32)
    gray = gray.reshape(-1, 1, 1, 1).astype(np.float32)
    noise = normals_color.astype(np.float32) * sigma / 255.0
    if normals_gray is not None and gray.any():
        noise_gray = normals_gray.astype(np.float32)[None, :, :, None] * sigma / 255.0
        noise = noise * (1 - gray) + noise_gray * gray
    return np.clip(out + noise, 0, 1)


def apply_poisson_noise_batch(out: np.ndarray, scale: np.ndarray, gray: np.ndarray,
                              poisson_fn=None) -> np.ndarray:
    """random_add_poisson_noise_pt given its draws: the image rounded to
    uint8 levels first (the rate and the subtracted base), vals per item from
    its count of levels, gray through torchvision's weights;
    ``poisson_fn(lam)`` draws (``np.random.poisson`` by default)."""
    if poisson_fn is None:
        poisson_fn = np.random.poisson
    b = out.shape[0]
    scale = scale.reshape(-1, 1, 1, 1).astype(np.float32)
    gray = gray.reshape(-1, 1, 1, 1).astype(np.float32)
    any_gray = bool((gray > 0).any())
    if any_gray:
        img_gray = _round_uint8_grid(_rgb_to_grayscale(out))
        vals_g = np.array([_poisson_vals(img_gray[i]) for i in range(b)],
                          np.float32).reshape(-1, 1, 1, 1)
        draw_g = poisson_fn(img_gray * vals_g).astype(np.float32)
        noise_gray = draw_g / vals_g - img_gray          # (b, h, w, 1), broadcast to 3
    img_c = _round_uint8_grid(out)
    vals_c = np.array([_poisson_vals(img_c[i]) for i in range(b)],
                      np.float32).reshape(-1, 1, 1, 1)
    draw_c = poisson_fn(img_c * vals_c).astype(np.float32)
    noise = draw_c / vals_c - img_c
    if any_gray:
        noise = noise * (1 - gray) + noise_gray * gray
    return np.clip(out + noise * scale, 0, 1)


def jpeg_np(img: np.ndarray, quality: float) -> np.ndarray:
    """Plain version of the host C++ JPEG: the DCT round trip of one
    (h, w, 3) image (the reference DiffJPEG's math, 0-padded to 16)."""
    h, w = img.shape[:2]
    ph, pw = (16 - h % 16) % 16, (16 - w % 16) % 16
    x = np.pad(img, ((0, ph), (0, pw), (0, 0))) * 255.0
    hp, wp = h + ph, w + pw
    ycc = x @ _RGB2YCBCR + np.array([0.0, 128.0, 128.0], np.float32)
    y, cb, cr = ycc[..., 0], ycc[..., 1], ycc[..., 2]
    cb = cb.reshape(hp // 2, 2, wp // 2, 2).mean(axis=(1, 3))
    cr = cr.reshape(hp // 2, 2, wp // 2, 2).mean(axis=(1, 3))
    factor = (5000.0 / quality if quality < 50 else 200.0 - quality * 2.0) / 100.0

    def roundtrip(chan, table):
        hh, ww = chan.shape
        b = (chan - 128.0).reshape(hh // 8, 8, ww // 8, 8).transpose(0, 2, 1, 3)
        coefs = np.einsum("ij,nmjk,lk->nmil", _DCT_NP, b, _DCT_NP)
        q = table * factor             # raw table * factor, as the reference DiffJPEG
        deq = np.round(coefs / q) * q
        rec = np.einsum("ji,nmjk,kl->nmil", _DCT_NP, deq, _DCT_NP)
        return rec.transpose(0, 2, 1, 3).reshape(hh, ww) + 128.0

    y2 = roundtrip(y, Y_TABLE)
    cb2 = np.repeat(np.repeat(roundtrip(cb, C_TABLE), 2, 0), 2, 1)
    cr2 = np.repeat(np.repeat(roundtrip(cr, C_TABLE), 2, 0), 2, 1)
    ycc2 = np.stack([y2, cb2 - 128.0, cr2 - 128.0], axis=-1)
    rgb = np.clip(ycc2 @ _YCBCR2RGB / 255.0, 0, 1)
    return rgb[:h, :w, :].astype(np.float32)


DEFAULT_STAGE_OPTS = dict(
    resize_prob=[0.2, 0.7, 0.1], resize_range=[0.15, 1.5],
    gaussian_noise_prob=0.5, noise_range=[1, 30], poisson_scale_range=[0.05, 3],
    gray_noise_prob=0.4, jpeg_range=[30, 95],
    second_blur_prob=0.8, resize_prob2=[0.3, 0.4, 0.3], resize_range2=[0.3, 1.2],
    gaussian_noise_prob2=0.5, noise_range2=[1, 25], poisson_scale_range2=[0.05, 2.5],
    gray_noise_prob2=0.4, jpeg_range2=[30, 95],
)


class TrainingPairPool:
    """The shuffled training-pair queue (reference _dequeue_and_enqueue
    :326-367): while it fills, batches pass through and are stored; once
    full, it is permuted with ``np.random.permutation`` (the global stream,
    as in the JAX package), its first b pairs are returned and the incoming
    ones take their slots."""

    def __init__(self, queue_size: int = 180):
        self.queue_size = queue_size
        self.ptr = 0
        self.buffers: dict[str, np.ndarray] | None = None

    def __call__(self, tensors: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        b = next(iter(tensors.values())).shape[0]
        if self.queue_size % b:
            raise ValueError(f"queue size {self.queue_size} should be divisible by batch size {b}")
        if self.buffers is None:
            self.buffers = {k: np.zeros((self.queue_size,) + v.shape[1:], v.dtype)
                            for k, v in tensors.items()}
        if self.ptr == self.queue_size:
            idx = np.random.permutation(self.queue_size)
            for k in self.buffers:
                self.buffers[k] = self.buffers[k][idx]
            out = {k: self.buffers[k][:b].copy() for k in self.buffers}
            for k, v in tensors.items():
                self.buffers[k][:b] = v
            return out
        for k, v in tensors.items():
            self.buffers[k][self.ptr:self.ptr + b] = v
        self.ptr += b
        return tensors


class RealESRGANDegrader:
    """Two-stage blind degradation of a batch with per-item kernels, then a
    random crop to ``gt_size``, the pool and (with ``use_sharpen``) USM.

    ``times`` adds up the seconds of each kind of work (``filter2d``,
    ``resize``, ``noise``, ``jpeg``, ``crop_pool``, ``usm``) over the calls,
    for the CLIs' timers; ``threads`` is the host C++'s thread count."""

    def __init__(self, opt: dict, scale: int = 4, queue_size: int = 180,
                 use_sharpen: bool = False, degradation_order: str = "two",
                 seed: int | None = None, threads: int = 8):
        self.o = {**DEFAULT_STAGE_OPTS,
                  **{k: v for k, v in opt.items() if k in DEFAULT_STAGE_OPTS}}
        self.scale = scale
        self.pool = TrainingPairPool(queue_size) if queue_size else None
        self.use_sharpen = use_sharpen
        self.order = degradation_order
        self.rng = np.random.RandomState(seed)
        self.pyrng = pyrandom.Random(seed)
        self.threads = threads
        self.times: dict[str, float] = defaultdict(float)

    def _timed(self, kind: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.times[kind] += time.perf_counter() - t0
        return out

    def _jpeg(self, out: np.ndarray, qualities) -> np.ndarray:
        return self._timed("jpeg", native.jpeg_roundtrip_batch, np.clip(out, 0, 1),
                           [float(q) for q in qualities], self.threads)

    def _filter(self, out: np.ndarray, kernels) -> np.ndarray:
        return self._timed("filter2d", native.filter2d_batch, out, kernels, self.threads)

    def _resize(self, out: np.ndarray, size_or_scale, mode: str) -> np.ndarray:
        return self._timed("resize", _resize, out, size_or_scale, mode)

    def _draw_noise_params(self, b: int, stage2: bool) -> dict:
        o = self.o
        suf = "2" if stage2 else ""
        use_gauss = bool(self.rng.uniform() < o[f"gaussian_noise_prob{suf}"])
        lo, hi = o[f"noise_range{suf}"] if use_gauss else o[f"poisson_scale_range{suf}"]
        return {
            "use_gauss": use_gauss,
            "level": self.rng.uniform(lo, hi, size=b),
            "gray": self.rng.uniform(size=b) < o[f"gray_noise_prob{suf}"],
            "normals": None, "normals_gray": None, "poisson": None,
        }

    def draw_plan(self, b: int) -> dict:
        """Every batch-level decision and per-item parameter of one
        ``degrade_batch`` call, in the JAX degrader's order of draws."""
        o = self.o

        def rand_resize(stage2):
            suf = "2" if stage2 else ""
            updown = self.pyrng.choices(["up", "down", "keep"], o[f"resize_prob{suf}"])[0]
            rrange = o[f"resize_range{suf}"]
            if updown == "up":
                s = float(self.rng.uniform(1, rrange[1]))
            elif updown == "down":
                s = float(self.rng.uniform(rrange[0], 1))
            else:
                s = 1.0
            mode = self.pyrng.choice(["area", "bilinear", "bicubic"])
            return s, mode

        s1, m1 = rand_resize(False)
        plan = {
            "scale1": s1, "mode1": m1,
            "noise1": self._draw_noise_params(b, False),
            "jpeg_q1": self.rng.uniform(*o["jpeg_range"], size=b),
        }
        if self.order == "two":
            s2, m2 = rand_resize(True)
            plan.update({
                "second_blur": bool(self.rng.uniform() < o["second_blur_prob"]),
                "scale2": s2, "mode2": m2,
                "noise2": self._draw_noise_params(b, True),
                "sinc_first": bool(self.rng.uniform() < 0.5),
                "final_mode": self.pyrng.choice(["area", "bilinear", "bicubic"]),
                "jpeg_q2": self.rng.uniform(*o["jpeg_range2"], size=b),
            })
        return plan

    def _apply_noise(self, out: np.ndarray, p: dict) -> np.ndarray:
        t0 = time.perf_counter()
        level = np.asarray(p["level"], np.float32)
        gray = np.asarray(p["gray"], np.float32)
        if p["use_gauss"]:
            normals = p["normals"]
            if normals is None:
                normals = self.rng.randn(*out.shape)
            normals_gray = p["normals_gray"]
            if normals_gray is None and gray.any():
                normals_gray = self.rng.randn(*out.shape[1:3])
            out = apply_gaussian_noise_batch(out, level, gray, normals, normals_gray)
        else:
            out = apply_poisson_noise_batch(out, level, gray, p["poisson"] or self.rng.poisson)
        self.times["noise"] += time.perf_counter() - t0
        return out

    def degrade_batch(self, gt: np.ndarray, kernel1, kernel2, sinc_kernel,
                      plan: dict | None = None) -> np.ndarray:
        """gt (b, h, w, 3) float32 in [0, 1] and the items' kernels -> the LQ
        (b, h // scale, w // scale, 3) on uint8 levels.  ``plan``
        (``draw_plan``'s layout) freezes every random decision."""
        b, ori_h, ori_w, _ = gt.shape
        if plan is None:
            plan = self.draw_plan(b)
        out = self._filter(gt, kernel1)
        out = self._resize(out, plan["scale1"], plan["mode1"])
        out = self._apply_noise(out, plan["noise1"])
        out = self._jpeg(out, plan["jpeg_q1"])
        target = (ori_h // self.scale, ori_w // self.scale)
        if self.order == "two":
            if plan["second_blur"]:
                out = self._filter(out, kernel2)
            h2 = int(ori_h / self.scale * plan["scale2"])
            w2 = int(ori_w / self.scale * plan["scale2"])
            out = self._resize(out, (h2, w2), plan["mode2"])
            out = self._apply_noise(out, plan["noise2"])
            if plan["sinc_first"]:
                out = self._resize(out, target, plan["final_mode"])
                out = self._filter(out, sinc_kernel)
                out = self._jpeg(out, plan["jpeg_q2"])
            else:
                out = self._jpeg(out, plan["jpeg_q2"])
                out = self._resize(out, target, plan["final_mode"])
                out = self._filter(out, sinc_kernel)
        else:
            # order 'one': the final resize takes the stage-1 mode (:204)
            out = self._resize(out, target, plan["mode1"])
        return (np.clip((out * 255.0).round(), 0, 255) / 255.0).astype(np.float32)

    def __call__(self, batch: dict) -> dict:
        """The reference's ``feed_data``: degrade, crop each pair at random to
        ``gt_size`` (from ``self.pyrng``), pass the pool, and add ``gt_usm``
        with ``use_sharpen``.  ``batch``: numpy ``gt`` (b, h, w, 3), the three
        kernels, optionally ``gt_mask`` (b, h, w, 1) and ``gt_size``."""
        gt = batch["gt"]
        lq = self.degrade_batch(gt, batch["kernel1"], batch["kernel2"], batch["sinc_kernel"])
        t0 = time.perf_counter()
        gt_size = batch.get("gt_size", gt.shape[1])
        mask = batch.get("gt_mask")
        if mask is None:
            mask = np.zeros(gt.shape[:3] + (1,), np.float32)
        gts, lqs, masks = [], [], []
        for i in range(gt.shape[0]):
            g, l, m = paired_random_crop_img_mask(gt[i], lq[i], mask[i], gt_size, self.scale,
                                                  rng=self.pyrng)
            gts.append(g)
            lqs.append(l)
            masks.append(m)
        tensors = {"gt": np.stack(gts), "lq": np.stack(lqs), "gt_mask": np.stack(masks)}
        if self.pool is not None:
            tensors = self.pool(tensors)
        self.times["crop_pool"] += time.perf_counter() - t0
        if self.use_sharpen:
            t0 = time.perf_counter()
            tensors["gt_usm"] = np.stack([usm_sharp_np(g) for g in tensors["gt"]])
            self.times["usm"] += time.perf_counter() - t0
        return tensors

    # ------------------------------------------------------------ persistence
    def get_state(self, with_pool: bool = True) -> dict:
        """The two streams and, with a pool and ``with_pool``, its pointer and
        buffers, as tensors, ints and tuples (what
        ``torch.load(weights_only=True)`` reads)."""
        name, keys, pos, has_gauss, gauss = self.rng.get_state()
        state = {"np_rng": (name, torch.from_numpy(keys.astype(np.int64)), pos, has_gauss, gauss),
                 "py_rng": self.pyrng.getstate()}
        if self.pool is not None and with_pool:
            state["pool_ptr"] = self.pool.ptr
            state["pool_buffers"] = (None if self.pool.buffers is None else
                                     {k: torch.from_numpy(v.copy())
                                      for k, v in self.pool.buffers.items()})
        return state

    def set_state(self, state: dict) -> None:
        name, keys, pos, has_gauss, gauss = state["np_rng"]
        self.rng.set_state((name, keys.numpy().astype(np.uint32), pos, has_gauss, gauss))
        version, internal, gauss_next = state["py_rng"]
        self.pyrng.setstate((version, tuple(internal), gauss_next))
        if self.pool is not None and "pool_ptr" in state:
            self.pool.ptr = int(state["pool_ptr"])
            buffers = state["pool_buffers"]
            self.pool.buffers = None if buffers is None else {
                k: v.numpy().copy() for k, v in buffers.items()}
