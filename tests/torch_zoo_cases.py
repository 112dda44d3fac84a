"""Cases of the strategy zoo (``losses/simself_strategies.py``) for the CPU
parity tests and ``chip_smoke.py``'s ``zoo`` phase: every key of the
reference's dispatch with its options, and seeded inputs.  Imports no JAX.

Sizes: tiles of 8 x 8 (dense families: neighbourhoods of 3), search 7 with
window 3 (masked families), on 16 x 16 images: every branch at a size where
a float64 run of both packages takes milliseconds.  ``scaled`` gives the same
options at the zoo's defaults (search / area 25, window 9, tiles 16), which
the card runs."""

import numpy as np

DENSE = ("imgimg", "gradimg", "gradgrad", "areaarea", "areaarea_ori", "areaarea_nonlocal",
         "areaarea_nonlocal_slow", "areaarea_cos", "areaarea_stride", "areaarea_pad_roll",
         "areaarea_gradfilter")
MASKED = ("areaarea_mask_nonlocal", "areaarea_mask_nonlocal_slow", "areaarea_mask_trans",
          "areaarea_mask_nonlocal_cuda_v1", "areaarea_mask_nonlocal_cuda_v2",
          "areaarea_mask_nonlocalavg_cuda_v1", "areaarea_mask_nonlocalavg_cuda_v2",
          "areaarea_mask_eulardistanceavg_cuda_v1", "areaarea_mask_nonlocalavg_cuda_v3",
          "areaarea_mask_nonlocalavg_cuda_v4", "areaarea_mask_nonlocalavg_cuda_v5")
PATCHED = ("areaarea_mask_nonlocal_patch", "areaarea_mask_trans_patch",
           "areaarea_mask_nonlocal_cuda_v1_patch")
RGB = "areaarea_mask_nonlocalavg_cuda_v1RGB"
# these two compare SR with GT inside one map: similarity_map only (through
# simself_strategy_loss, which passes no img_sr, both packages refuse them)
PAIRED = ("areaarea_mask_nonlocalavg_cuda_maxh_v1", "areaarea_mask_nonlocal_patch_mutual")
DEAD = "areaarea_mask_nonlocalavg_cuda_v1_p"
KEYS = DENSE + MASKED + PATCHED + (RGB,) + PAIRED
LOSS_KEYS = DENSE + MASKED + PATCHED + (RGB,)

# similarity_map's options by key, beyond the defaults
_EXTRA = {
    "imgimg": dict(is_shift=True, shift_h=3, shift_w=5),
    "gradimg": dict(gray=True, is_shift=True, shift_h=2, shift_w=2),
    "gradgrad": dict(gray=True),
    "areaarea": dict(mean=True, temperature=0.7, is_shift=True, shift_h=4, shift_w=4),
    "areaarea_ori": dict(is_shift=True, shift_h=4, shift_w=4),
    "areaarea_nonlocal": dict(scaling_factor=2),
    "areaarea_nonlocal_slow": dict(scaling_factor=2),
    "areaarea_cos": dict(temperature=0.5),
    "areaarea_pad_roll": dict(shift_h=4, shift_w=4),
    "areaarea_gradfilter": dict(temperature=0.5),
    "areaarea_mask_trans": dict(mean=True, var=True, softmax=False),
    "areaarea_mask_trans_patch": dict(mean=True),
    "areaarea_mask_nonlocalavg_cuda_v4": dict(kernel_size_center=[3, 5]),
    "areaarea_mask_nonlocalavg_cuda_v5": dict(gene_type="softmax", largest_k=5),
}
SIZE, TILE, AREA, SEARCH, WINDOW = 16, 8, 3, 7, 3


def map_kwargs(key: str, scaled: bool = False) -> dict:
    """similarity_map's keyword arguments for ``key`` (softmax on)."""
    tile, area, search, window = (16, 25, 25, 9) if scaled else (TILE, AREA, SEARCH, WINDOW)
    kw = dict(dh=tile, dw=tile, softmax=True, scaling_factor=1.0)
    if key in DENSE:
        kw["kernel_size"] = area
    else:
        kw.update(kernel_size=search, kernel_size_center=window)
    kw.update(_EXTRA.get(key, {}))
    if scaled and key == "areaarea_mask_nonlocalavg_cuda_v4":
        kw["kernel_size_center"] = [5, 9, 13]
    return kw


def loss_opts(key: str, scaled: bool = False) -> tuple:
    """``SSLSetting.strategy_opts`` for ``key``: the zoo's keys of
    ``map_kwargs`` (softmax_sr on, softmax_gt off; without ``var``, whose
    division by a window's variance makes logits of hundreds)."""
    kw = map_kwargs(key, scaled)
    opts = dict(simself_dh=kw["dh"], simself_dw=kw["dw"], kernel_size=kw["kernel_size"],
                scaling_factor=kw["scaling_factor"], softmax_sr=True, softmax_gt=False)
    for k in ("kernel_size_center", "temperature", "mean", "gene_type", "largest_k"):
        if k in kw:
            opts[k] = kw[k]
    return tuple(sorted(opts.items()))


def images(seed: int, b: int = 1, size: int = SIZE, mask_channels: int = 1,
           density: float = 0.2):
    """(gt, sr, mask) NCHW float64 in [0, 1] and a 0/1 mask, one tile of the
    first image empty (the ``_patch`` skip) and one edge pixel kept."""
    rng = np.random.RandomState(seed)
    gt = rng.rand(b, 3, size, size)
    sr = np.clip(gt + 0.1 * rng.randn(*gt.shape), 0, 1)
    mask = (rng.rand(b, mask_channels, size, size) < density).astype(np.float64)
    mask[0, :, :size // 2, :size // 2] = 0.0
    mask[0, :, size - 3, size - 5] = 1.0
    return gt, sr, mask
