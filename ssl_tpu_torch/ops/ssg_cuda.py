"""K1 on Hopper: the fused SSL-loss forward as a CUDA kernel, with the analytic
backward behind a ``torch.autograd.Function``.

Counterpart of ``ssl_tpu/ops/ssg_pallas.py`` (``ssl_loss_sums_pallas``).  The
kernel source is ``ssl_tpu_torch/csrc/ssg_loss_fwd.cu``.  For a CUDA tensor
the forward launches that kernel (or raises); for a CPU tensor it runs the
plain version ``ssl_loss_sums_reference``.  Either way the backward is
``ssl_loss_dense_bwd`` in plain PyTorch, fed the forward's ``inv_*`` and
``a_map``/``b_map`` maps so that it skips its own T pass.

``SSGConfig``'s bf16 knobs pick K1's mode (``k1_modes``): on a CUDA tensor a
bf16 request launches that mode, never the plain version.  With the bf16 q
store (the stored route) K1 is two kernels: the walk, which writes the
inverse maps and the q stack (plain version ``q_stack_reference``), and the
stream, which takes the loss sums and the maps from that stack (plain
version ``q_stream_reference``)."""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ssl_tpu_torch.ops.cuda_build import load_library
from ssl_tpu_torch.ops.ssg import (BF16, SSGConfig, check_config, reflect_pad_2d,
                                   ssl_loss_dense_bwd, ssl_loss_sums_reference)

# Launches of the K1 kernel (ssg_loss_fwd_kernel: the whole forward, or with
# the bf16 store the walk) in this process, one per ``ssg_loss_fwd_cuda``
# call, and by mode (``k1_modes``); and of the bf16 store's stream kernel
# (ssg_loss_fwd_stream_kernel).
launches = 0
launches_by_mode = {}
stream_launches = 0

# The kernel's block (csrc/ssg_loss_fwd.cu): 8 warps over a tile 32 pixels
# wide and 32 - 2k rows high (k = window // 2), so that the tile's rows with
# their k-row halo are one per lane; the walk of the bf16 stream + store mode
# (SR and GT staged as bf16x2 pairs) takes K1_WALK16_WARPS.
K1_TILE_W, K1_REGION_ROWS, K1_WARPS = 32, 32, 8
K1_WALK16_WARPS = 16
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


def k1_launch(b: int, c: int, h: int, w: int, search: int, window: int,
              mode: tuple = (0, 0)) -> K1Launch:
    """The geometry ``ssg_loss_fwd`` launches with in K1's ``mode``
    (``k1_modes``); its layout of shared memory, in floats: both staged
    images (2c planes of (th + 2p) rows of pitch 32 + 2p + 1), C2 over the
    region (2 x 32 rows of 32 + 2k + 1), its window row sums H9 (2 x 32 x
    33), the inverse maps, the mask and the inverse maps' logs (5 x th x 32),
    the block sums (3 x warps) and each warp's scratch (a row of D, then H1,
    per image and lane: 2 x 32 rows of 32 + 2k + 1).  In the bf16 stream +
    store mode (the walk) the images are c planes of bf16x2 (SR, GT) cells,
    the maps only the inverse two, and the warps K1_WALK16_WARPS."""
    p, k = search // 2, window // 2
    th = K1_REGION_ROWS - 2 * k
    if th < 1:
        raise ValueError(f"K1 takes windows up to {K1_REGION_ROWS - 1}, got {window}")
    ip, cp, hp = K1_TILE_W + 2 * p + 1, K1_TILE_W + 2 * k + 1, K1_TILE_W + 1
    pairs = mode == (1, 1)
    warps = K1_WALK16_WARPS if pairs else K1_WARPS
    floats = ((1 if pairs else 2) * c * (th + 2 * p) * ip + 2 * K1_REGION_ROWS * cp
              + 2 * K1_REGION_ROWS * hp + (2 if pairs else 5) * th * K1_TILE_W + 3 * warps
              + warps * 2 * K1_REGION_ROWS * cp)
    grid = (-(-w // K1_TILE_W), -(-h // th), b)
    return K1Launch((th, K1_TILE_W), grid, grid[0] * grid[1] * grid[2], 32 * warps, 4 * floats)


class K1StreamLaunch(NamedTuple):
    """The stream kernel's launch: grid (blocks, one a ``threads`` pixels,
    = rows of its ``partial``) and threads a block."""
    grid: tuple
    blocks: int
    threads: int


def k1_stream_launch(b: int, h: int, w: int) -> K1StreamLaunch:
    """The geometry ``ssg_loss_fwd_stream`` launches with: one thread a pixel
    of the b h w, 256 a block (K1_WARPS warps, as the walk's block)."""
    threads = 32 * K1_WARPS
    blocks = -(-(b * h * w) // threads)
    return K1StreamLaunch((blocks, 1, 1), blocks, threads)


def k1_stack_shape(b: int, h: int, w: int, search: int) -> tuple:
    """The walk's q stack, offset-major: (search^2, b, h, w, 2) bf16, each
    pixel-offset's pair (bf16(q_sr), bf16(q_sr - q_gt)) adjacent; the
    search^2 x 2b x h x w values that ``losses/ssl_loss.py::dense_route``
    budgets for the bf16 stored route."""
    return (search * search, b, h, w, 2)



def k1_modes(cfg: SSGConfig) -> tuple:
    """K1's mode for ``cfg``: (stream_bf16, store_bf16), each 0 or 1 (the
    kernel's STREAM16 and STORE16 template parameters)."""
    return int(cfg.stream_dtype == BF16), int(cfg.q_store_dtype == BF16)


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssg_loss_fwd.argtypes = [p] * 9 + [i] * 6 + [ctypes.c_float, i, i, i, p]
    lib.ssg_loss_fwd.restype = i
    lib.ssg_loss_fwd_stream.argtypes = [p] * 7 + [i, ctypes.c_longlong, p]
    lib.ssg_loss_fwd_stream.restype = i
    lib.ssg_loss_fwd_stream_blocks.argtypes = [ctypes.c_longlong]
    lib.ssg_loss_fwd_stream_blocks.restype = i
    lib.ssg_loss_fwd_blocks.argtypes = [i, i, i, i]
    lib.ssg_loss_fwd_blocks.restype = i
    lib.ssg_loss_fwd_smem_bytes.argtypes = [i, i, i, i, i]
    lib.ssg_loss_fwd_smem_bytes.restype = i
    lib.ssg_loss_fwd_threads.argtypes = [i, i]
    lib.ssg_loss_fwd_threads.restype = i
    lib.ssg_cuda_error_string.argtypes = [i]
    lib.ssg_cuda_error_string.restype = ctypes.c_char_p


def _check_inputs(sr, gt, mask, cfg: SSGConfig) -> None:
    if sr.dim() != 4 or gt.shape != sr.shape:
        raise ValueError(f"sr and gt must both be (b, c, h, w), got {tuple(sr.shape)} "
                         f"and {tuple(gt.shape)}")
    b, _, h, w = sr.shape
    if mask is not None and mask.shape != (b, h, w):
        raise ValueError(f"mask must be (b, h, w) = {(b, h, w)}, got {tuple(mask.shape)}")
    for name, t in (("sr", sr), ("gt", gt)) + ((("mask", mask),) if mask is not None else ()):
        if t.device != sr.device:
            raise ValueError(f"{name} is on {t.device}, sr on {sr.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    p = cfg.search // 2
    if p >= h or p >= w:
        raise ValueError(f"reflect padding by {p} needs images larger than {p}, got {h}x{w}")


def _walk(sr, gt, mask, cfg: SSGConfig, stack):
    """Launch ssg_loss_fwd_kernel (the whole forward, or with the bf16 store
    the walk, which writes ``stack`` and reads no ``mask``: None there);
    returns its partials and the four (b, h, w) maps, of which the walk
    writes the inverse two."""
    global launches
    check_config(cfg)
    if not sr.is_cuda:
        raise ValueError("K1's kernels take CUDA tensors")
    _check_inputs(sr, gt, mask, cfg)
    mode = k1_modes(cfg)
    if sr.shape[1] != 3 and any(mode):
        raise ValueError(f"K1's bf16 modes take 3 channels, got {sr.shape[1]}")
    lib = load_library("ssg_loss_fwd", _declare)
    b, c, h, w = sr.shape
    p = cfg.search // 2
    psr = reflect_pad_2d(sr.detach(), p).contiguous()
    pgt = reflect_pad_2d(gt.detach(), p).contiguous()
    geom = k1_launch(b, c, h, w, cfg.search, cfg.window, mode)
    if geom.smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"search {cfg.search} and window {cfg.window} need {geom.smem_bytes} "
                         f"bytes of shared memory a block, more than the {MAX_SMEM_BYTES} K1 "
                         "may take")
    if (lib.ssg_loss_fwd_blocks(b, h, w, cfg.window),
            lib.ssg_loss_fwd_smem_bytes(c, cfg.search, cfg.window, *mode),
            lib.ssg_loss_fwd_threads(*mode)) != (geom.blocks, geom.smem_bytes, geom.threads):
        raise RuntimeError("csrc/ssg_loss_fwd.cu and ssg_cuda.k1_launch disagree on the launch")
    partial = torch.empty((geom.blocks, 3), device=sr.device, dtype=torch.float32)
    maps = [torch.empty((b, h, w), device=sr.device, dtype=torch.float32) for _ in range(4)]
    with torch.cuda.device(sr.device):     # the C entry launches on the current device
        err = lib.ssg_loss_fwd(psr.data_ptr(), pgt.data_ptr(),
                               None if mask is None else mask.data_ptr(),
                               partial.data_ptr(), *(m.data_ptr() for m in maps),
                               None if stack is None else stack.data_ptr(), b, c, h, w,
                               cfg.search, cfg.window, float(cfg.sigma),
                               int(cfg.generalization), *mode,
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssg_loss_fwd launch failed: {lib.ssg_cuda_error_string(err).decode()}")
    launches += 1
    launches_by_mode[mode] = launches_by_mode.get(mode, 0) + 1
    return partial, maps


def q_stack_cuda(sr: torch.Tensor, gt: torch.Tensor, cfg: SSGConfig = SSGConfig()):
    """Launch K1's walk (the bf16 store's sweep 1; ``cfg.q_store_dtype`` must
    be bfloat16) on CUDA tensors; returns what ``q_stack_reference`` does:
    (stack, inv_sr, inv_gt)."""
    if k1_modes(cfg)[1] != 1:
        raise ValueError("K1's walk is the bf16 q store's: q_store_dtype must be bfloat16")
    if not sr.is_cuda:
        raise ValueError("q_stack_cuda takes CUDA tensors")
    b, _, h, w = sr.shape
    stack = torch.empty(k1_stack_shape(b, h, w, cfg.search), device=sr.device,
                        dtype=torch.bfloat16)
    _, maps = _walk(sr, gt, None, cfg, stack)
    return stack, maps[0], maps[1]


def q_stream_cuda(stack: torch.Tensor, inv_sr: torch.Tensor, inv_gt: torch.Tensor,
                  mask: torch.Tensor):
    """Launch K1's stream (the bf16 store's sweep 2) over the walk's ``stack``
    on CUDA tensors; returns what ``q_stream_reference`` does: (l1_sum,
    kl_sum, count, a_map, b_map)."""
    global stream_launches
    if not stack.is_cuda:
        raise ValueError("K1's stream takes CUDA tensors")
    b, h, w = inv_sr.shape
    if (stack.dim() != 5 or tuple(stack.shape[1:]) != (b, h, w, 2)
            or stack.dtype != torch.bfloat16 or not stack.is_contiguous()):
        raise ValueError(f"stack must be a contiguous (n2, {b}, {h}, {w}, 2) bf16 tensor, got "
                         f"{tuple(stack.shape)} {stack.dtype}")
    for name, t in (("inv_sr", inv_sr), ("inv_gt", inv_gt), ("mask", mask)):
        if (tuple(t.shape) != (b, h, w) or t.dtype != torch.float32 or t.device != stack.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({b}, {h}, {w}) float32 tensor on "
                             f"{stack.device}")
    lib = load_library("ssg_loss_fwd", _declare)
    geom = k1_stream_launch(b, h, w)
    if lib.ssg_loss_fwd_stream_blocks(b * h * w) != geom.blocks:
        raise RuntimeError("csrc/ssg_loss_fwd.cu and ssg_cuda.k1_stream_launch disagree on the "
                           "launch")
    partial = torch.empty((geom.blocks, 3), device=stack.device, dtype=torch.float32)
    a_map, b_map = (torch.empty((b, h, w), device=stack.device, dtype=torch.float32)
                    for _ in range(2))
    with torch.cuda.device(stack.device):
        err = lib.ssg_loss_fwd_stream(stack.data_ptr(), inv_sr.data_ptr(), inv_gt.data_ptr(),
                                      mask.data_ptr(), partial.data_ptr(), a_map.data_ptr(),
                                      b_map.data_ptr(), stack.shape[0], b * h * w,
                                      torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssg_loss_fwd_stream launch failed: "
                           f"{lib.ssg_cuda_error_string(err).decode()}")
    stream_launches += 1
    l1, kl, count = partial.sum(dim=0)
    return l1, kl, count, a_map, b_map


def ssg_loss_fwd_cuda(sr: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                      cfg: SSGConfig = SSGConfig()):
    """Launch K1 on CUDA tensors; returns what ``ssl_loss_sums_reference`` does.
    With the bf16 q store: the walk, then the stream over the q stack, which
    lives for this call only."""
    if not sr.is_cuda:
        raise ValueError("ssg_loss_fwd_cuda takes CUDA tensors")
    if k1_modes(cfg)[1] == 1:
        stack, inv_sr, inv_gt = q_stack_cuda(sr, gt, cfg)
        l1, kl, count, a_map, b_map = q_stream_cuda(stack, inv_sr, inv_gt, mask)
        return l1, kl, count, inv_sr, inv_gt, a_map, b_map
    partial, maps = _walk(sr, gt, mask, cfg, None)
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
