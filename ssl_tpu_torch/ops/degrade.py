"""The two-stage blind degradation of RealESRGAN-SSL, on the card.

Counterpart of ``ssl_tpu/ops/degrade_jax.py`` (reference
realesrganssl_model.py feed_data :148-317), split in two:

* ``draw_degradation`` makes every random choice of one batch, a
  ``DegradeDraws``: the per-batch choices (up / down / keep, the size
  bucket, the resize mode, Gaussian or Poisson noise, the second blur, the
  order of the final sinc and JPEG) from a host ``torch.Generator``, so that
  picking a size needs no device-to-host read; the per-item values and the
  noise fields from a generator on the batch's device.
* ``degrade_two_stage`` is deterministic given the draws.  It computes only
  the branch the draws chose (the JAX step evaluates every branch and picks
  with ``jnp.where`` / ``lax.switch``).

What the JAX package made static, and the port keeps exactly: the resize
scale is bucketed (``bucket_table``: ``n_buckets`` sizes spanning the range,
each ``max(16, round(s base / 8) 8)``); up picks a bucket at or above the one
nearest scale 1, down one at or below it, keep that one; the noise is added
at the bucket's size, then the image returns to a common canvas (H / 2 after
stage 1, the target H / scale after stage 2); stage 1's JPEG runs on the
canvas; the final sinc and JPEG run at the target in the drawn order; the
output is rounded to uint8 levels.

The Poisson samples depend on the image at that point, so the draws carry
them as a function ``poisson(rate, stage, which)`` (``which`` is "gray" or
"color"), called once per stage that draws Poisson noise, gray first."""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ssl_tpu_torch.ops.diffjpeg import diff_jpeg
from ssl_tpu_torch.ops.img_process import filter2d
from ssl_tpu_torch.ops.torch_resize import MODES, interp_torch


class DegradeConfig(NamedTuple):
    """``ssl_tpu``'s ``DegradeJaxConfig``: the option file's top-level keys
    of the same names."""
    scale: int = 4
    # stage 1
    resize_prob: Sequence[float] = (0.2, 0.7, 0.1)     # up, down, keep
    resize_range: Sequence[float] = (0.15, 1.5)
    gaussian_noise_prob: float = 0.5
    noise_range: Sequence[float] = (1, 30)
    poisson_scale_range: Sequence[float] = (0.05, 3)
    gray_noise_prob: float = 0.4
    jpeg_range: Sequence[float] = (30, 95)
    # stage 2
    second_blur_prob: float = 0.8
    resize_prob2: Sequence[float] = (0.3, 0.4, 0.3)
    resize_range2: Sequence[float] = (0.3, 1.2)
    gaussian_noise_prob2: float = 0.5
    noise_range2: Sequence[float] = (1, 25)
    poisson_scale_range2: Sequence[float] = (0.05, 2.5)
    gray_noise_prob2: float = 0.4
    jpeg_range2: Sequence[float] = (30, 95)
    n_buckets: int = 7

    @classmethod
    def from_opt(cls, opt: dict) -> "DegradeConfig":
        kwargs = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in opt.items() if k in cls._fields}
        kwargs["scale"] = opt.get("scale", 4)
        return cls(**kwargs)

    def stage(self, n: int) -> dict:
        """Stage ``n``'s (1 or 2) resize and noise settings by their stage-1 names."""
        sfx = "" if n == 1 else "2"
        return {k: getattr(self, k + sfx) for k in (
            "resize_prob", "resize_range", "gaussian_noise_prob", "noise_range",
            "poisson_scale_range", "gray_noise_prob")}


def bucket_table(rrange: Sequence[float], base_size: int, n_buckets: int):
    """(the bucket sizes, the index of the bucket nearest scale 1)."""
    scales = np.linspace(rrange[0], rrange[1], n_buckets)
    sizes = [max(16, int(round(s * base_size / 8)) * 8) for s in scales]
    return sizes, int(np.argmin(np.abs(scales - 1.0)))


def bucket_index(updown: int, up_idx: int, down_idx: int, one_idx: int) -> int:
    """The bucket of an up (0), down (1) or keep (2) draw."""
    return up_idx if updown == 0 else down_idx if updown == 1 else one_idx


class StageDraws(NamedTuple):
    """One stage's draws.  ``sigma`` (b,) and the normal fields (``normals``
    (b, 3, s, s) at the bucket's size s, ``normals_gray`` (1, 1, s, s), one
    field shared by the batch: a reference quirk) are drawn for Gaussian
    noise only, ``pscale`` (b,) for Poisson only; ``gray`` (b,) is 0 or 1."""
    updown: int
    bucket: int
    mode: int                 # index into MODES: area, bilinear, bicubic
    use_gauss: bool
    gray: torch.Tensor
    sigma: torch.Tensor | None = None
    normals: torch.Tensor | None = None
    normals_gray: torch.Tensor | None = None
    pscale: torch.Tensor | None = None


class DegradeDraws(NamedTuple):
    """Every random choice of ``degrade_two_stage`` for one batch."""
    stage1: StageDraws
    jpeg1: torch.Tensor       # (b,) stage 1's JPEG qualities
    do_blur2: bool
    stage2: StageDraws
    first_sinc: bool          # the final sinc before the JPEG, or after it
    jpeg2: torch.Tensor       # (b,) the final JPEG's qualities
    poisson: Callable[[torch.Tensor, int, str], torch.Tensor]


def _uniform(shape, lo, hi, gen: torch.Generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def _draw_stage(s: dict, base_size: int, n_buckets: int, b: int, host: torch.Generator,
                dev: torch.Generator, device) -> StageDraws:
    sizes, one_idx = bucket_table(s["resize_range"], base_size, n_buckets)
    probs = torch.tensor(s["resize_prob"], dtype=torch.float64)
    updown = int(torch.multinomial(probs, 1, generator=host))
    up_idx = int(torch.randint(one_idx, n_buckets, (), generator=host))
    down_idx = int(torch.randint(0, one_idx + 1, (), generator=host))
    mode = int(torch.randint(0, len(MODES), (), generator=host))
    use_gauss = bool(torch.rand((), generator=host) < s["gaussian_noise_prob"])
    bucket = bucket_index(updown, up_idx, down_idx, one_idx)
    gray = (torch.rand(b, generator=dev, device=device) < s["gray_noise_prob"]).float()
    if not use_gauss:
        return StageDraws(updown, bucket, mode, False, gray,
                          pscale=_uniform(b, *s["poisson_scale_range"], dev, device))
    size = sizes[bucket]
    return StageDraws(updown, bucket, mode, True, gray,
                      sigma=_uniform(b, *s["noise_range"], dev, device),
                      normals=torch.randn((b, 3, size, size), generator=dev, device=device),
                      normals_gray=torch.randn((1, 1, size, size), generator=dev, device=device))


def draw_degradation(cfg: DegradeConfig, b: int, gt_size: int, host: torch.Generator,
                     dev: torch.Generator) -> DegradeDraws:
    """The draws of one batch of ``b`` GT images of ``gt_size``^2: the
    per-batch choices from ``host`` (a CPU generator), the rest from ``dev``
    (a generator on the batch's device), in this order: stage 1, its JPEG,
    the second blur, stage 2, the final order and JPEG."""
    device = dev.device
    stage1 = _draw_stage(cfg.stage(1), gt_size, cfg.n_buckets, b, host, dev, device)
    jpeg1 = _uniform(b, *cfg.jpeg_range, dev, device)
    do_blur2 = bool(torch.rand((), generator=host) < cfg.second_blur_prob)
    stage2 = _draw_stage(cfg.stage(2), gt_size // cfg.scale, cfg.n_buckets, b, host, dev,
                         device)
    first_sinc = bool(torch.rand((), generator=host) < 0.5)
    jpeg2 = _uniform(b, *cfg.jpeg_range2, dev, device)

    def poisson(rate, stage, which):
        return torch.poisson(rate, generator=dev)
    return DegradeDraws(stage1, jpeg1, do_blur2, stage2, first_sinc, jpeg2, poisson)


def round_uint8_grid(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(img * 255.0), 0, 255) / 255.0


def poisson_vals(img_rounded: torch.Tensor) -> torch.Tensor:
    """Per image 2^ceil(log2(n)), n the count of distinct uint8 levels
    (the reference's ``len(unique)``), as (b, 1, 1, 1)."""
    b = img_rounded.shape[0]
    levels = torch.round(img_rounded * 255.0).long().reshape(b, -1)
    hist = torch.zeros((b, 256), dtype=torch.int32, device=img_rounded.device)
    hist.scatter_add_(1, levels, torch.ones_like(levels, dtype=torch.int32))
    n = (hist > 0).sum(dim=1).to(img_rounded.dtype)
    return (2.0 ** torch.ceil(torch.log2(torch.clamp(n, min=1.0)))).reshape(b, 1, 1, 1)


def apply_gaussian_noise(img, sigma, gray, normals, normals_gray) -> torch.Tensor:
    """Reference random_add_gaussian_noise_pt: per-item sigma and gray, a
    colour field per item, one gray field for the batch."""
    sigma, gray = sigma.reshape(-1, 1, 1, 1), gray.reshape(-1, 1, 1, 1)
    noise = normals * sigma / 255.0
    noise_gray = normals_gray * sigma / 255.0
    noise = noise * (1 - gray) + noise_gray * gray
    return torch.clamp(img + noise, 0.0, 1.0)


def apply_poisson_noise(img, scale, gray, sample: Callable[[torch.Tensor, str], torch.Tensor]):
    """Reference random_add_poisson_noise_pt: a uint8-rounded base, per-image
    vals from its count of distinct levels, torchvision's gray weights;
    ``sample(rate, which)`` draws Poisson(rate), gray before colour."""
    scale, gray = scale.reshape(-1, 1, 1, 1), gray.reshape(-1, 1, 1, 1)
    img_gray = round_uint8_grid(0.2989 * img[:, 0:1] + 0.587 * img[:, 1:2] + 0.114 * img[:, 2:3])
    vals_g = poisson_vals(img_gray)
    noise_gray = sample(img_gray * vals_g, "gray") / vals_g - img_gray
    img_c = round_uint8_grid(img)
    vals_c = poisson_vals(img_c)
    noise = sample(img_c * vals_c, "color") / vals_c - img_c
    noise = noise * (1 - gray) + noise_gray * gray
    return torch.clamp(img + noise * scale, 0.0, 1.0)


def _resize_stage(img, d: StageDraws, rrange, base_size: int, out_size: int, n_buckets: int,
                  poisson: Callable[[torch.Tensor, str], torch.Tensor]) -> torch.Tensor:
    """Resize to the drawn bucket's size, add the drawn noise there, and
    resize back to ``out_size`` in the same mode."""
    size = bucket_table(rrange, base_size, n_buckets)[0][d.bucket]
    mode = MODES[d.mode]
    mid = interp_torch(img, (size, size), mode)
    if d.use_gauss:
        mid = apply_gaussian_noise(mid, d.sigma, d.gray, d.normals, d.normals_gray)
    else:
        mid = apply_poisson_noise(mid, d.pscale, d.gray, poisson)
    return interp_torch(mid, (out_size, out_size), mode)


def _jpeg(img: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    return diff_jpeg(torch.clamp(img, 0, 1), quality)


@torch.no_grad()
def degrade_two_stage(gt: torch.Tensor, kernel1: torch.Tensor, kernel2: torch.Tensor,
                      sinc_kernel: torch.Tensor, cfg: DegradeConfig,
                      draws: DegradeDraws) -> torch.Tensor:
    """gt (b, 3, H, H) in [0, 1], kernels (b, 21, 21) -> LQ (b, 3, H / scale,
    H / scale) on uint8 levels."""
    h = gt.shape[-1]
    target = h // cfg.scale
    out = filter2d(gt, kernel1)
    out = _resize_stage(out, draws.stage1, cfg.resize_range, h, h // 2, cfg.n_buckets,
                        lambda rate, which: draws.poisson(rate, 1, which))
    out = _jpeg(out, draws.jpeg1)
    if draws.do_blur2:
        out = filter2d(out, kernel2)
    out = _resize_stage(out, draws.stage2, cfg.resize_range2, target, target, cfg.n_buckets,
                        lambda rate, which: draws.poisson(rate, 2, which))
    if draws.first_sinc:
        out = _jpeg(filter2d(out, sinc_kernel), draws.jpeg2)
    else:
        out = filter2d(_jpeg(out, draws.jpeg2), sinc_kernel)
    return round_uint8_grid(out)
