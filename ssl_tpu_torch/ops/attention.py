"""Scaled-dot-product attention, routed to the hand-written flash kernels (K2).

Counterpart of ``ssl_tpu/ops/attention.py``.  Same function as there,
softmax(q kᵀ sm_scale) v over (b, seq, heads, d) tensors, and the same
eligibility rule, with "the tensors lie on CUDA" in place of "the backend is
a TPU".  An eligible call launches K2's forward (``ops/attention_cuda.py``,
``csrc/flash_attn_fwd.cu``) or raises; with a gradient to take, it goes
through ``FlashAttention``, whose backward launches K2's two backward kernels
(``csrc/flash_attn_bwd.cu``) or raises, as upstream's custom VJP runs two
Pallas kernels on the TPU.  Every other call, and every call on the CPU,
takes the plain version below (einsum, softmax in float32, cast back, and
autograd through it), which the JAX package takes for the same shapes.

Beside the kernels stand their plain contracts: ``attention_lse_reference``
(the forward's per-row log-sum-exp) and ``flash_attn_bwd_reference`` (the
backward's recompute formula), on float32 or bf16 inputs; in bf16 with the
kernels' rounding points and float32 arithmetic between them.  At d = 512
the backward runs in two halves through a P/dS scratch, and each half has
its own: ``flash_attn_bwd_p_ds_reference`` and
``flash_attn_bwd_mm_reference``.  The CPU tests and ``chip_smoke.py`` hold
the kernels against them; no path on a card calls them."""

from __future__ import annotations

import torch

from ssl_tpu_torch.ops import attention_cuda


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


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Each row's log-sum-exp of the scaled logits, (b, heads, n) float32: the
    plain version of what K2's forward writes for the backward.  bf16 q and k
    are multiplied and summed in float32, as the kernel's fp32 accumulators
    take their products."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * sm_scale
    return torch.logsumexp(logits, dim=-1)


def flash_attn_bwd_reference(q, k, v, o, lse, do, sm_scale: float):
    """The plain version of K2's backward: (dq, dk, dv) in q's type from the
    forward's output o and log-sum-exp lse and the incoming gradient dO, by
    the recompute formula of upstream's custom VJP:
        P = exp(sm_scale q kᵀ - lse)    dP = dO vᵀ    di = rowsum(o * dO)
        dS = P * (dP - di)    dV = Pᵀ dO    dK = sm_scale dSᵀ q    dQ = sm_scale dS k
    In float32 throughout for float32 inputs.  For bf16 inputs the kernel's
    contract: every product of bf16 operands summed in float32, P and dS
    formed in float32 and rounded to bf16 where they enter dV, dK and dQ, and
    the gradients rounded to bf16 once."""
    def operand(x):          # where the kernel rounds to the inputs' type
        return x.to(q.dtype).float()

    q32, k32, v32, o32, do32 = (t.float() for t in (q, k, v, o, do))
    p = torch.exp(torch.einsum("bnhd,bmhd->bhnm", q32, k32) * sm_scale - lse[..., None])
    dp = torch.einsum("bnhd,bmhd->bhnm", do32, v32)
    di = (o32 * do32).sum(-1).transpose(1, 2)
    ds = operand(p * (dp - di[..., None]))
    dv = torch.einsum("bhnm,bnhd->bmhd", operand(p), do32)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q32) * sm_scale
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k32) * sm_scale
    return tuple(g.to(q.dtype) for g in (dq, dk, dv))


def flash_attn_fwd_combine_reference(o_parts, m_parts, l_parts, dtype=torch.bfloat16):
    """The plain version of ``flash_attn_fwd_combine[_bf16]``: the parts of a
    split key loop, each part's unnormalised output o_parts[s] (b, n, heads,
    d) with its row max m_parts[s] and row sum l_parts[s] (b, heads, n),
    merged in order: o = sum_s e^(m_s - M) o_s / L, lse = M + log L, with M
    the largest m_s and L = sum_s e^(m_s - M) l_s.  Returns (o in ``dtype``,
    lse in float32)."""
    top = m_parts.amax(0)
    o, total = 0.0, 0.0
    for acc, m_, l_ in zip(o_parts, m_parts, l_parts):
        w = torch.exp(m_ - top)
        total = total + w * l_
        o = o + w.transpose(1, 2)[..., None] * acc
    return (o / total.transpose(1, 2)[..., None]).to(dtype), top + torch.log(total)


def flash_attn_bwd_p_ds_reference(q, k, v, o, lse, do, sm_scale: float) -> torch.Tensor:
    """The plain version of the d = 512 backward's first kernel: P and dS of
    ``flash_attn_bwd_reference``, formed in float32 and stacked as the
    scratch holds them, a (2, b, heads, n, m) tensor in q's type."""
    q32, k32, v32, o32, do32 = (t.float() for t in (q, k, v, o, do))
    p = torch.exp(torch.einsum("bnhd,bmhd->bhnm", q32, k32) * sm_scale - lse[..., None])
    dp = torch.einsum("bnhd,bmhd->bhnm", do32, v32)
    di = (o32 * do32).sum(-1).transpose(1, 2)
    return torch.stack((p, p * (dp - di[..., None]))).to(q.dtype)


def flash_attn_bwd_mm_reference(p_ds, q, k, do, sm_scale: float):
    """The plain version of the d = 512 backward's two products, dkv_mm and
    dq_mm: (dq, dk, dv) in q's type from the scratch ``p_ds`` (2, b, heads, n,
    m) of P and dS:
        dV = Pᵀ dO    dK = sm_scale dSᵀ q    dQ = sm_scale dS k
    each product of the operands as given summed in float32 (float64 for
    float64 inputs) and scaled, then rounded to q's type once."""
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    p, ds = p_ds.to(acc)
    q32, k32, do32 = (t.to(acc) for t in (q, k, do))
    dv = torch.einsum("bhnm,bnhd->bmhd", p, do32)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q32) * sm_scale
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k32) * sm_scale
    return tuple(g.to(q.dtype) for g in (dq, dk, dv))


class FlashAttention(torch.autograd.Function):
    """K2 with its gradient: the forward kernel writes o and lse, the backward
    kernels recompute the probabilities from them.  Under
    ``torch.utils.checkpoint`` the replayed forward launches the forward
    kernel again and saves a fresh lse."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, lse = attention_cuda.flash_attn_fwd_cuda(q, k, v, sm_scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        """dq, dk and dv in the inputs' type (the kernels' outputs)."""
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_cuda.flash_attn_bwd_cuda(q, k, v, o, lse, do, ctx.sm_scale)
        return dq, dk, dv, None


def sdp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
                  use_flash: bool = False) -> torch.Tensor:
    """softmax(q @ kᵀ * sm_scale) @ v over (b, seq, heads, d) tensors."""
    n, m = q.shape[1], k.shape[1]
    if not flash_eligible(n, m, use_flash, q.device):
        return sdp_attention_reference(q, k, v, sm_scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, sm_scale)
    return attention_cuda.flash_attn_fwd_cuda(q, k, v, sm_scale)
