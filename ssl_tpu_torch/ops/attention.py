"""Scaled-dot-product attention, routed to the hand-written flash kernel (K2).

Counterpart of ``ssl_tpu/ops/attention.py``.  Same function as there,
softmax(q kᵀ sm_scale) v over (b, seq, heads, d) tensors, and the same
eligibility rule, with "the tensors lie on CUDA" in place of "the backend is
a TPU": an eligible call launches K2 (``ops/attention_cuda.py``,
``csrc/flash_attn_fwd.cu``) or raises; every other call, and every call on
the CPU, takes the plain version below (einsum, softmax in float32, cast
back), which the JAX package takes for the same shapes.

K2 has no backward yet.  A gradient through an eligible CUDA call raises
``NotImplementedError``; it never quietly takes the plain path."""

from __future__ import annotations

import torch

TRAINING_SLICE = ("K2's backward comes with the diffusion training slice "
                  "(ROADMAP.md, queue 1 item 1 and queue 2 item 2)")


def flash_eligible(n: int, m: int, use_flash: bool, device) -> bool:
    """The switch on, CUDA tensors, lane-aligned sequence lengths, long enough
    to win (ssl_tpu/ops/attention.py:21-25).  The 77-token cross-attention
    context is never eligible."""
    return (bool(use_flash) and torch.device(device).type == "cuda"
            and n % 128 == 0 and m % 128 == 0 and n >= 512)


def sdp_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            sm_scale: float) -> torch.Tensor:
    """The plain version (ssl_tpu/ops/attention.py:43-46): the logits and
    their softmax in float32, then cast back to v's type."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * sm_scale
    attn = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", attn.to(v.dtype), v)


def sdp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
                  use_flash: bool = False) -> torch.Tensor:
    """softmax(q @ kᵀ * sm_scale) @ v over (b, seq, heads, d) tensors."""
    n, m = q.shape[1], k.shape[1]
    if not flash_eligible(n, m, use_flash, q.device):
        return sdp_attention_reference(q, k, v, sm_scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(f"gradient through the flash attention kernel: {TRAINING_SLICE}")
    from ssl_tpu_torch.ops.attention_cuda import flash_attn_fwd_cuda
    return flash_attn_fwd_cuda(q, k, v, sm_scale)
