"""K1 on Hopper: the fused SSL-loss forward as a CUDA kernel, with the analytic
backward behind a ``torch.autograd.Function``.

Counterpart of ``ssl_tpu/ops/ssg_pallas.py`` (``ssl_loss_sums_pallas``).  The
kernel source is ``ssl_tpu_torch/csrc/ssg_loss_fwd.cu``.  For a CUDA tensor
the forward launches that kernel (or raises); for a CPU tensor it runs the
plain version ``ssl_loss_sums_reference``.  Either way the backward is
``ssl_loss_dense_bwd`` in plain PyTorch, fed the forward's ``inv_*`` and
``a_map``/``b_map`` maps so that it skips its own T pass."""

from __future__ import annotations

import ctypes

import torch

from ssl_tpu_torch.ops.cuda_build import load_library
from ssl_tpu_torch.ops.ssg import (SSGConfig, check_config, reflect_pad_2d,
                                   ssl_loss_dense_bwd, ssl_loss_sums_reference)

# Launches of the K1 kernel in this process (one per ``ssg_loss_fwd_cuda`` call).
launches = 0


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssg_loss_fwd.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float, i, p]
    lib.ssg_loss_fwd.restype = i
    lib.ssg_loss_fwd_blocks.argtypes = [i, i, i]
    lib.ssg_loss_fwd_blocks.restype = i
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
    lib = load_library("ssg_loss_fwd", _declare)
    b, c, h, w = sr.shape
    p = cfg.search // 2
    psr = reflect_pad_2d(sr.detach(), p).contiguous()
    pgt = reflect_pad_2d(gt.detach(), p).contiguous()
    partial = torch.empty((lib.ssg_loss_fwd_blocks(b, h, w), 3), device=sr.device,
                          dtype=torch.float32)
    maps = [torch.empty((b, h, w), device=sr.device, dtype=torch.float32) for _ in range(4)]
    with torch.cuda.device(sr.device):     # the C entry launches on the current device
        err = lib.ssg_loss_fwd(psr.data_ptr(), pgt.data_ptr(), mask.data_ptr(),
                               partial.data_ptr(), *(m.data_ptr() for m in maps), b, c, h, w,
                               cfg.search, cfg.window, float(cfg.sigma),
                               int(cfg.generalization), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssg_loss_fwd launch failed: {lib.ssg_cuda_error_string(err).decode()}")
    launches += 1
    l1, kl, count = partial.sum(dim=0)
    return (l1, kl, count, *maps)


class SSLLossSums(torch.autograd.Function):
    """(l1_sum, kl_sum, count) of the SSL loss; differentiable w.r.t. sr only."""

    @staticmethod
    def forward(ctx, sr, gt, mask, cfg):
        fwd = ssg_loss_fwd_cuda if sr.is_cuda else ssl_loss_sums_reference
        l1, kl, count, inv_sr, inv_gt, a_map, b_map = fwd(sr, gt, mask, cfg)
        ctx.cfg = cfg
        ctx.save_for_backward(sr, gt, mask, inv_sr, inv_gt, a_map, b_map)
        ctx.mark_non_differentiable(count)
        return l1, kl, count

    @staticmethod
    def backward(ctx, g_l1, g_kl, _g_count):
        sr, gt, mask, inv_sr, inv_gt, a_map, b_map = ctx.saved_tensors
        d_sr = ssl_loss_dense_bwd(sr, gt, mask, inv_sr, inv_gt, g_l1, g_kl, ctx.cfg,
                                  a_map=a_map, b_map=b_map)
        return d_sr, None, None, None


def ssl_loss_sums(sr: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                  cfg: SSGConfig = SSGConfig()):
    """Fused masked-dense SSL loss sums for a batch: sr, gt (b, c, h, w),
    mask (b, h, w) -> (l1_sum, kl_sum, count).  Divide by count * search^2
    for the reference's mean.  gt is a constant target."""
    check_config(cfg)
    _check_inputs(sr, gt, mask, cfg)
    return SSLLossSums.apply(sr, gt.detach(), mask, cfg)
