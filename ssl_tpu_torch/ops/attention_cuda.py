"""K2 on Hopper: the flash-attention forward as a CUDA kernel.

Replaces the Pallas TPU flash attention that ``ssl_tpu/ops/attention.py``
(``sdp_attention``, flash branch :32-39) calls.  The kernel source is
``ssl_tpu_torch/csrc/flash_attn_fwd.cu``.  It reads q, k and v through their
(b, seq, heads, d) strides, so the UNet's (b, n, heads·d) projections and the
head-major packed qkv of ``AttentionBlockQKV`` go in without a copy, and
writes a contiguous (b, n, heads, d) output.  Callers route through
``ops/attention.py::sdp_attention``, which checks eligibility."""

from __future__ import annotations

import ctypes

import torch

from ssl_tpu_torch.ops.cuda_build import load_library

# Launches of the K2 kernel in this process (one per ``flash_attn_fwd_cuda`` call).
launches = 0

# Head widths the kernel is instantiated for (a template on d in the source):
# the serving path's UNet and struct-cond heads and the VAE's single head.
HEAD_DIMS = (64, 128, 512)


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attn_fwd.argtypes = [p] * 4 + [ll] * 12 + [i] * 5 + [ctypes.c_float, p]
    lib.flash_attn_fwd.restype = i
    lib.flash_attn_error_string.argtypes = [i]
    lib.flash_attn_error_string.restype = ctypes.c_char_p


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernel takes: float32 (b, seq, heads, d) tensors on one device,
    unit stride along d, n and m multiples of 128, d in ``HEAD_DIMS``."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q, k, v must be (b, seq, heads, d) with k and v alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, n, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in b, heads or d")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride along d, got strides {t.stride()}")
    if n % 128 or k.shape[1] % 128:
        raise ValueError(f"sequence lengths must be multiples of 128, got n={n}, m={k.shape[1]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d} is not one of the kernel's {HEAD_DIMS}")


def flash_attn_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float) -> torch.Tensor:
    """Launch K2 on CUDA tensors; returns what ``sdp_attention_reference`` does."""
    global launches
    if not q.is_cuda:
        raise ValueError("flash_attn_fwd_cuda takes CUDA tensors")
    check_inputs(q, k, v)
    lib = load_library("flash_attn_fwd", _declare)
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), device=q.device, dtype=torch.float32)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):     # the C entry launches on the current device
        err = lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 *strides, b, h, n, k.shape[1], d, float(sm_scale),
                                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: {lib.flash_attn_error_string(err).decode()}")
    launches += 1
    return out
