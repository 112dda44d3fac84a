"""K1 on Hopper: the fused SSL-loss forward as a CUDA kernel, with the analytic
backward behind a ``torch.autograd.Function``.

Counterpart of ``ssl_tpu/ops/ssg_pallas.py`` (``ssl_loss_sums_pallas``).  The
kernel source is ``ssl_tpu_torch/csrc/ssg_loss_fwd.cu``.  For a CUDA tensor
the forward launches that kernel (or raises); for a CPU tensor it runs the
plain version ``ssl_loss_sums_reference``.  Either way the backward is
``ssl_loss_dense_bwd`` in plain PyTorch, fed the forward's ``inv_*`` and
``a_map``/``b_map`` maps so that it skips its own T pass.

``SSGConfig``'s bf16 knobs pick K1's mode (``k1_modes``): on a CUDA tensor a
bf16 request launches that mode, never the plain version."""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ssl_tpu_torch.ops.cuda_build import load_library
from ssl_tpu_torch.ops.ssg import (BF16, SSGConfig, check_config, reflect_pad_2d,
                                   ssl_loss_dense_bwd, ssl_loss_sums_reference)

# Launches of the K1 kernel in this process (one per ``ssg_loss_fwd_cuda`` call),
# and by mode (``k1_modes``).
launches = 0
launches_by_mode = {}

# The kernel's block (csrc/ssg_loss_fwd.cu): 8 warps over a tile 32 pixels
# wide and 32 - 2k rows high (k = window // 2), so that the tile's rows with
# their k-row halo are one per lane.
K1_TILE_W, K1_REGION_ROWS, K1_WARPS = 32, 32, 8
# Shared memory a block may take on an H100 (227 KB).
MAX_SMEM_BYTES = 232448


class K1Launch(NamedTuple):
    """K1's launch geometry: tile (rows, columns), grid (x, y, z), blocks
    (= rows of ``partial``), threads a block and dynamic shared memory."""
    tile: tuple
    grid: tuple
    blocks: int
    threads: int
    smem_bytes: int


def k1_launch(b: int, c: int, h: int, w: int, search: int, window: int) -> K1Launch:
    """The geometry ``ssg_loss_fwd`` launches with; its layout of shared
    memory, in floats: both staged images (2c planes of (th + 2p) rows of
    pitch 32 + 2p + 1), C2 over the region (2 x 32 rows of 32 + 2k + 1), its
    window row sums H9 (2 x 32 x 33), the inverse maps, the mask and the
    inverse maps' logs (5 x th x 32), the block sums (3 x 8) and each warp's
    scratch (a row of D, then H1, per image and lane: 2 x 32 rows of
    32 + 2k + 1)."""
    p, k = search // 2, window // 2
    th = K1_REGION_ROWS - 2 * k
    if th < 1:
        raise ValueError(f"K1 takes windows up to {K1_REGION_ROWS - 1}, got {window}")
    ip, cp, hp = K1_TILE_W + 2 * p + 1, K1_TILE_W + 2 * k + 1, K1_TILE_W + 1
    floats = (2 * c * (th + 2 * p) * ip + 2 * K1_REGION_ROWS * cp + 2 * K1_REGION_ROWS * hp
              + 5 * th * K1_TILE_W + 3 * K1_WARPS
              + K1_WARPS * 2 * K1_REGION_ROWS * cp)
    grid = (-(-w // K1_TILE_W), -(-h // th), b)
    return K1Launch((th, K1_TILE_W), grid, grid[0] * grid[1] * grid[2], 32 * K1_WARPS, 4 * floats)


def k1_modes(cfg: SSGConfig) -> tuple:
    """K1's mode for ``cfg``: (stream_bf16, store_bf16), each 0 or 1 (the
    kernel's STREAM16 and STORE16 template parameters)."""
    return int(cfg.stream_dtype == BF16), int(cfg.q_store_dtype == BF16)


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssg_loss_fwd.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float, i, i, i, p]
    lib.ssg_loss_fwd.restype = i
    lib.ssg_loss_fwd_blocks.argtypes = [i, i, i, i]
    lib.ssg_loss_fwd_blocks.restype = i
    lib.ssg_loss_fwd_smem_bytes.argtypes = [i, i, i]
    lib.ssg_loss_fwd_smem_bytes.restype = i
    lib.ssg_cuda_error_string.argtypes = [i]
    lib.ssg_cuda_error_string.restype = ctypes.c_char_p


def _check_inputs(sr, gt, mask, cfg: SSGConfig) -> None:
    if sr.dim() != 4 or gt.shape != sr.shape:
        raise ValueError(f"sr and gt must both be (b, c, h, w), got {tuple(sr.shape)} "
                         f"and {tuple(gt.shape)}")
    b, _, h, w = sr.shape
    if mask.shape != (b, h, w):
        raise ValueError(f"mask must be (b, h, w) = {(b, h, w)}, got {tuple(mask.shape)}")
    for name, t in (("sr", sr), ("gt", gt), ("mask", mask)):
        if t.device != sr.device:
            raise ValueError(f"{name} is on {t.device}, sr on {sr.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    p = cfg.search // 2
    if p >= h or p >= w:
        raise ValueError(f"reflect padding by {p} needs images larger than {p}, got {h}x{w}")


def ssg_loss_fwd_cuda(sr: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                      cfg: SSGConfig = SSGConfig()):
    """Launch K1 on CUDA tensors; returns what ``ssl_loss_sums_reference`` does."""
    global launches
    check_config(cfg)
    if not sr.is_cuda:
        raise ValueError("ssg_loss_fwd_cuda takes CUDA tensors")
    _check_inputs(sr, gt, mask, cfg)
    if sr.shape[1] != 3 and any(k1_modes(cfg)):
        raise ValueError(f"K1's bf16 modes take 3 channels, got {sr.shape[1]}")
    lib = load_library("ssg_loss_fwd", _declare)
    b, c, h, w = sr.shape
    p = cfg.search // 2
    psr = reflect_pad_2d(sr.detach(), p).contiguous()
    pgt = reflect_pad_2d(gt.detach(), p).contiguous()
    geom = k1_launch(b, c, h, w, cfg.search, cfg.window)
    if geom.smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"search {cfg.search} and window {cfg.window} need {geom.smem_bytes} "
                         f"bytes of shared memory a block, more than the {MAX_SMEM_BYTES} K1 "
                         "may take")
    if (lib.ssg_loss_fwd_blocks(b, h, w, cfg.window), lib.ssg_loss_fwd_smem_bytes(
            c, cfg.search, cfg.window)) != (geom.blocks, geom.smem_bytes):
        raise RuntimeError("csrc/ssg_loss_fwd.cu and ssg_cuda.k1_launch disagree on the launch")
    partial = torch.empty((geom.blocks, 3), device=sr.device, dtype=torch.float32)
    maps = [torch.empty((b, h, w), device=sr.device, dtype=torch.float32) for _ in range(4)]
    with torch.cuda.device(sr.device):     # the C entry launches on the current device
        err = lib.ssg_loss_fwd(psr.data_ptr(), pgt.data_ptr(), mask.data_ptr(),
                               partial.data_ptr(), *(m.data_ptr() for m in maps), b, c, h, w,
                               cfg.search, cfg.window, float(cfg.sigma),
                               int(cfg.generalization), *k1_modes(cfg),
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssg_loss_fwd launch failed: {lib.ssg_cuda_error_string(err).decode()}")
    launches += 1
    mode = k1_modes(cfg)
    launches_by_mode[mode] = launches_by_mode.get(mode, 0) + 1
    l1, kl, count = partial.sum(dim=0)
    return (l1, kl, count, *maps)


class SSLLossSums(torch.autograd.Function):
    """(l1_sum, kl_sum, count) of the SSL loss; differentiable w.r.t. sr only.
    ``stored``: the JAX stored route's backward (``ssl_loss_dense_bwd``)."""

    @staticmethod
    def forward(ctx, sr, gt, mask, cfg, stored):
        fwd = ssg_loss_fwd_cuda if sr.is_cuda else ssl_loss_sums_reference
        l1, kl, count, inv_sr, inv_gt, a_map, b_map = fwd(sr, gt, mask, cfg)
        ctx.cfg, ctx.stored = cfg, stored
        ctx.save_for_backward(sr, gt, mask, inv_sr, inv_gt, a_map, b_map)
        ctx.mark_non_differentiable(count)
        return l1, kl, count

    @staticmethod
    def backward(ctx, g_l1, g_kl, _g_count):
        sr, gt, mask, inv_sr, inv_gt, a_map, b_map = ctx.saved_tensors
        d_sr = ssl_loss_dense_bwd(sr, gt, mask, inv_sr, inv_gt, g_l1, g_kl, ctx.cfg,
                                  a_map=a_map, b_map=b_map, stored=ctx.stored)
        return d_sr, None, None, None, None


def ssl_loss_sums(sr: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                  cfg: SSGConfig = SSGConfig(), stored: bool = False):
    """Fused masked-dense SSL loss sums for a batch: sr, gt (b, c, h, w),
    mask (b, h, w) -> (l1_sum, kl_sum, count).  Divide by count * search^2
    for the reference's mean.  gt is a constant target.  ``stored`` picks
    the JAX stored route (``losses/ssl_loss.py::dense_route``): the bf16
    store applies there only."""
    check_config(cfg)
    if cfg.q_store_dtype == BF16 and not stored:
        raise ValueError("q_store_dtype bfloat16 applies to the stored route only")
    _check_inputs(sr, gt, mask, cfg)
    return SSLLossSums.apply(sr, gt.detach(), mask, cfg, stored)
