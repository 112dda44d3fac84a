"""Inputs of the port's attention tests, made with numpy from a seed.

Imports neither JAX nor ssl_tpu, so that the card-only tests
(``test_torch_cuda.py``) can use it on a machine without JAX.

Each case is (b, heads, n, m, d, sm_scale, layout, logit range):
``proj`` lays q, k and v out as the UNet's ``to_q``/``to_k``/``to_v`` give
them, (b, seq, heads·d) viewed as (b, seq, heads, d); ``qkv`` slices them out
of one head-major packed (b, seq, heads, 3, d) tensor, as
``AttentionBlockQKV`` does, so they are strided views.  q and k are scaled so
that the largest |q·k·sm_scale| over the first 256 rows is the logit range."""

import numpy as np
import torch

from ssl_tpu_torch.ops.attention import flash_attn_fwd_combine_reference

# the K2 shapes of the diffusion serving path at 512^2 (64^2 latent), ssl_base.yml
CUDA_CASES = {
    "unet_ds1": (1, 4, 4096, 4096, 64, 64 ** -0.5, "proj", 8.0),
    "unet_ds2": (1, 8, 1024, 1024, 64, 64 ** -0.5, "proj", 8.0),
    "struct_ds1": (1, 4, 4096, 4096, 64, 1.0, "qkv", 8.0),
    "struct_ds2": (1, 4, 1024, 1024, 128, 1.0, "qkv", 8.0),
    "vae_mid": (1, 1, 4096, 4096, 512, 512 ** -0.5, "proj", 8.0),
    "large_logits": (2, 2, 512, 1024, 64, 64 ** -0.5, "proj", 50.0),
}

# the K2 shapes of the diffusion training path at 512^2, batch 2 (the same
# attentions with the batch doubled), where the backward runs too; K2
# launches of one training mini-step by case: forward with lse, and backward
TRAIN_CASES = {
    "unet_ds1": (2, 4, 4096, 4096, 64, 64 ** -0.5, "proj", 8.0),
    "struct_ds1": (2, 4, 4096, 4096, 64, 1.0, "qkv", 8.0),
    "unet_ds2": (2, 8, 1024, 1024, 64, 64 ** -0.5, "proj", 8.0),
    "struct_ds2": (2, 4, 1024, 1024, 128, 1.0, "qkv", 8.0),
    "vae_mid": (2, 1, 4096, 4096, 512, 512 ** -0.5, "proj", 8.0),
    "large_logits": (2, 2, 512, 1024, 64, 64 ** -0.5, "proj", 50.0),
}
TRAIN_MIX_BWD = {"unet_ds1": 5, "struct_ds1": 2, "unet_ds2": 5, "struct_ds2": 2, "vae_mid": 1}


def attention_inputs(b, heads, n, m, d, sm_scale, layout, logit_range, seed=0, device="cpu",
                     dtype=torch.float32):
    """(q, k, v) as (b, seq, heads, d) tensors of ``dtype`` in the given
    layout: the float32 draws, rounded once where ``dtype`` is bf16."""
    rng = np.random.RandomState(seed)
    if layout == "qkv":
        if n != m:
            raise ValueError("the packed qkv layout is self-attention: n == m")
        qkv = rng.randn(b, n, heads, 3, d).astype(np.float32)
        q, k = qkv[..., 0, :], qkv[..., 1, :]
    else:
        q, k, v = (rng.randn(b, s, heads, d).astype(np.float32) for s in (n, m, m))
    top = np.abs(np.einsum("bnhd,bmhd->bhnm", q[:, :256], k[:, :256]) * sm_scale).max()
    gain = np.float32((logit_range / top) ** 0.5)
    if layout == "qkv":
        qkv[..., :2, :] *= gain
        t = torch.from_numpy(qkv).to(device=device, dtype=dtype)
        return t[..., 0, :], t[..., 1, :], t[..., 2, :]
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype)
                 for a in (q * gain, k * gain, v))


# K2 backward's holds on the card (chip_smoke.py BWD_REL_L2, BWD_RTOL,
# BWD_ATOL): each of dq, dk, dv within this relative L2, and elementwise
# within rtol with an atol of BWD_ATOL times the gradient's largest value.
BWD_REL_L2, BWD_RTOL, BWD_ATOL = 1e-4, 1e-3, 1e-4


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as cvt.rna.tf32.f32 does: to the nearest of the
    10-bit mantissa, ties away from zero; the low 13 bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def einsum_tf32(spec: str, a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """A product of float32 tensors as the tensor cores take it: with passes=3
    (3xTF32) x = big + small, big = tf32(x), small = tf32(x - big), and the
    product small·big + big·small + big·big; with passes=1 (single-pass
    TF32) big·big alone.  The TF32 products are exact in float32; they are
    summed here in float64 and rounded once."""
    ab, bb = tf32(a), tf32(b)
    terms = [(ab, bb)]
    if passes == 3:
        a_s, b_s = tf32(a - ab), tf32(b - bb)
        terms += [(a_s, bb), (ab, b_s)]
    return sum(torch.einsum(spec, x.double(), y.double()) for x, y in terms).float()


def flash_attn_bwd_tf32(q, k, v, o, lse, do, sm_scale: float, passes: int = 3):
    """flash_attn_bwd_reference with its five products in ``einsum_tf32``:
    the arithmetic of the CUDA kernels (csrc/flash_attn_bwd.cu)."""
    p = torch.exp(einsum_tf32("bnhd,bmhd->bhnm", q, k, passes) * sm_scale - lse[..., None])
    dp = einsum_tf32("bnhd,bmhd->bhnm", do, v, passes)
    di = (o * do).sum(-1).transpose(1, 2)
    ds = p * (dp - di[..., None])
    dv = einsum_tf32("bhnm,bnhd->bmhd", p, do, passes)
    dk = einsum_tf32("bhnm,bnhd->bmhd", ds, q, passes) * sm_scale
    dq = einsum_tf32("bhnm,bmhd->bnhd", ds, k, passes) * sm_scale
    return dq, dk, dv


# K2 forward's hold on the card (chip_smoke.py phase_k2): rtol with an atol of
# FWD_ATOL times the output's largest value.
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5

# K2's bf16 holds on the card (chip_smoke.py, tests/test_torch_cuda.py),
# against the float32 plain version on the same bf16 inputs upcast: the
# forward's o within BF16_FWD_REL_L2 relative L2, the backward's dq, dk and dv
# (fed the float32 reference's o and lse) within BF16_BWD_REL_L2, each at most
# BF16_PLAIN_RATIO times the error of the plain bf16 version on the same
# reference (the forward: the JAX einsum path in bf16; the backward:
# flash_attn_bwd_reference on the bf16 inputs).
BF16_FWD_REL_L2, BF16_BWD_REL_L2, BF16_PLAIN_RATIO = 5e-3, 1e-2, 1.5

# The hold of the bf16 d = 512 backward's two products alone (dkv_mm and
# dq_mm, chip_smoke.py, tests/test_torch_cuda.py): on a given bf16 scratch of
# P and dS and bf16 q, k and dO, each of dq, dk and dv within MM_REL_L2
# relative L2 of the float64 products of the same bf16 values and at most
# MM_LIBRARY_RATIO times cuBLAS's error (``mm_library_calls``) on them.  Both
# sum in float32 and round to bf16 once, which alone costs ~1.7e-3.
MM_REL_L2, MM_LIBRARY_RATIO = 2e-3, 1.1
# The second d = 512 shape the products are held at besides vae_mid's
# training batch: an odd count of 128-key tiles (dkv_mm's rows) and 12 tiles
# of dkv_mm, 8 of dq_mm, each block of the grid taking one.
MM_ODD_CASE = (1, 1, 512, 384, 512, 512 ** -0.5, "proj", 8.0)


def mm_library_calls(p_ds, q, k, do, sm_scale: float) -> dict:
    """The yardstick of the d = 512 backward's products: for each of dq, dk
    and dv a call of one ``torch.baddbmm(..., beta=0, alpha=scale)`` (cuBLAS)
    on the (b·heads, n, m) views of the scratch ``p_ds`` (2, b, heads, n, m)
    and (b·heads, seq, d) views of q, k and dO, in their type, returning the
    gradient as a (b, seq, heads, d) view.  For bf16 the caller turns
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    off, so that the sums stay in float32 as the kernels keep them; for
    float32, TF32.  The port never calls it."""
    b, n, h, d = q.shape
    m = k.shape[1]
    p, ds = (x.reshape(b * h, n, m) for x in p_ds)
    qh, kh, doh = (t.transpose(1, 2).reshape(b * h, -1, d) for t in (q, k, do))

    def call(a, bm, seq, alpha):
        out = torch.empty((b * h, seq, d), device=q.device, dtype=q.dtype)
        return lambda: torch.baddbmm(out, a, bm, beta=0, alpha=alpha).view(
            b, h, seq, d).transpose(1, 2)

    return {"dq": call(ds, kh, n, sm_scale), "dk": call(ds.transpose(1, 2), qh, m, sm_scale),
            "dv": call(p.transpose(1, 2), doh, m, 1.0)}


def flash_attn_fwd_tf32(q, k, v, sm_scale: float, block_k: int = 32, split: int = 1):
    """The forward's arithmetic (csrc/flash_attn_fwd.cu): key tiles of
    ``block_k``, each tile's logits and P·V in ``einsum_tf32``, the online
    softmax in float32, and each tile's P·V folded into the output as
    o = alpha·o + tile.  With ``split`` the key loop runs in that many parts
    that ``combine_parts`` merges.  Returns (o, lse (b, heads, n))."""
    m = k.shape[1]
    bounds = [(s * m // split, (s + 1) * m // split) for s in range(split)]
    parts = [_fwd_part(q, k[:, a:e], v[:, a:e], sm_scale, block_k) for a, e in bounds]
    if split == 1:
        acc, row_m, row_l = parts[0]
        return acc / row_l.transpose(1, 2)[..., None], row_m + torch.log(row_l)
    return combine_parts(parts)


def _fwd_part(q, k, v, sm_scale, block_k):
    """One part of the key loop: the unnormalised output (b, n, heads, d) and
    each row's max and sum (b, heads, n)."""
    b, n, h, d = q.shape
    acc = torch.zeros((b, n, h, d))
    row_m = torch.full((b, h, n), float("-inf"))
    row_l = torch.zeros((b, h, n))
    for k0 in range(0, k.shape[1], block_k):
        s = einsum_tf32("bnhd,bmhd->bhnm", q, k[:, k0:k0 + block_k]) * sm_scale
        m_new = torch.maximum(row_m, s.amax(-1))
        alpha = torch.exp(row_m - m_new)
        p = torch.exp(s - m_new[..., None])
        row_l = row_l * alpha + p.sum(-1)
        row_m = m_new
        tile = einsum_tf32("bhnm,bmhd->bnhd", p, v[:, k0:k0 + block_k])
        acc = alpha.transpose(1, 2)[..., None] * acc + tile
    return acc, row_m, row_l


def combine_parts(parts):
    """What flash_attn_fwd_combine_kernel does with the parts [(acc, m, l)],
    in order (``ops/attention.py::flash_attn_fwd_combine_reference``, o in
    the parts' type): o = sum_s e^(m_s - M) acc_s / L, lse = M + log L, with
    M the largest m_s and L = sum_s e^(m_s - M) l_s."""
    o_parts, m_parts, l_parts = (torch.stack(t) for t in zip(*parts))
    return flash_attn_fwd_combine_reference(o_parts, m_parts, l_parts, o_parts.dtype)
