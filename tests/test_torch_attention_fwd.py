"""K2's forward arithmetic and launch plan against ssl_tpu (fp32, CPU).

The CUDA kernels (csrc/flash_attn_fwd.cu) cannot run here, so their
arithmetic is modelled in ``tests/torch_attention_cases.py``:
``flash_attn_fwd_tf32`` takes key tiles of 32, both products in 3xTF32
(``einsum_tf32``), the online softmax in float32 and a per-tile fold of
P·V into the output.  It is held against ``ssl_tpu``'s ``sdp_attention``
(its einsum path on the CPU) within chip_smoke.py's forward hold (rtol 1e-4
with an atol of 1e-5 of the output's largest value), and its lse against
``jax.nn.logsumexp`` within the forward-lse hold of chip_smoke.py's
backward phase (rtol 1e-5, atol 1e-5).  The split key loop merged by
``combine_parts`` equals the unsplit model up to float32 rounding (rtol 1e-5,
atol 1e-6 of the largest value: the parts rescale by other maxima).
``fwd_plan`` is checked at every shape the serving and training paths give
it on an H100's 132 SMs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.ops import attention as jattn
from ssl_tpu_torch.ops import attention, attention_cuda
from torch_attention_cases import (CUDA_CASES, FWD_ATOL, FWD_RTOL, TRAIN_CASES, attention_inputs,
                                   flash_attn_fwd_tf32)


@pytest.mark.parametrize("d,layout,logits", [
    (d, layout, logits) for d in (16, 64) for layout in ("proj", "qkv") for logits in (8.0, 50.0)])
def test_3xtf32_forward_meets_the_hold(d, layout, logits):
    b, h, n, scale = 2, 2, 256, d ** -0.5
    q, k, v = attention_inputs(b, h, n, n, d, scale, layout, logits, seed=d + 2)
    o, lse = flash_attn_fwd_tf32(q, k, v, scale)
    ref = np.asarray(jattn.sdp_attention(*(t.numpy() for t in (q, k, v)), scale, use_flash=True))
    np.testing.assert_allclose(o.numpy(), ref, rtol=FWD_RTOL, atol=FWD_ATOL * np.abs(ref).max())
    ref_lse = jax.nn.logsumexp(jnp.einsum("bnhd,bmhd->bhnm", q.numpy(), k.numpy()) * scale, -1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("split", [2, 4, 8])
def test_split_and_combine_equal_the_unsplit_model(split):
    q, k, v = attention_inputs(1, 2, 128, 512, 64, 0.125, "proj", 50.0, seed=7)
    o, lse = flash_attn_fwd_tf32(q, k, v, 0.125)
    o_s, lse_s = flash_attn_fwd_tf32(q, k, v, 0.125, split=split)
    np.testing.assert_allclose(o_s.numpy(), o.numpy(), rtol=1e-5,
                               atol=1e-6 * float(o.abs().max()))
    np.testing.assert_allclose(lse_s.numpy(), lse.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d,split", [(64, 2), (128, 4), (512, 2), (64, 8)])
def test_combine_reference_merges_split_parts_into_attention(d, split):
    """``flash_attn_fwd_combine_reference``, the plain version of
    ``flash_attn_fwd_combine_bf16``, on parts made as the bf16 forward makes
    them (per key chunk: the row max m_s of the scaled logits, the
    unnormalised P·V and the row sum, all float32) at the head widths and
    splits of the bf16 serving plan, at the serving cases' logits (up to
    8): o in float32 against ssl_tpu's ``sdp_attention`` within the forward
    hold (FWD_RTOL, FWD_ATOL of the largest value), lse against
    ``jax.nn.logsumexp`` (1e-5), and in bf16 that o rounded once, bit for
    bit."""
    b, h, n, m, scale = 1, 2, 128, 128 * split, d ** -0.5
    q, k, v = attention_inputs(b, h, n, m, d, scale, "proj", 8.0, seed=d + split)
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    parts = []
    for s_ in range(split):
        chunk = logits[..., 128 * s_:128 * (s_ + 1)]
        top = chunk.amax(-1)
        p = torch.exp(chunk - top[..., None])
        parts.append((torch.einsum("bhnm,bmhd->bnhd", p, v[:, 128 * s_:128 * (s_ + 1)]), top,
                      p.sum(-1)))
    o_parts, m_parts, l_parts = (torch.stack(t) for t in zip(*parts))
    o, lse = attention.flash_attn_fwd_combine_reference(o_parts, m_parts, l_parts, torch.float32)
    ref = np.asarray(jattn.sdp_attention(*(t.numpy() for t in (q, k, v)), scale, use_flash=True))
    np.testing.assert_allclose(o.numpy(), ref, rtol=FWD_RTOL, atol=FWD_ATOL * np.abs(ref).max())
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(logits.numpy(), -1)),
                               rtol=1e-5, atol=1e-5)
    o16, lse16 = attention.flash_attn_fwd_combine_reference(o_parts, m_parts, l_parts)
    assert o16.dtype == torch.bfloat16 and torch.equal(o16, o.to(torch.bfloat16))
    assert torch.equal(lse16, lse)


# The splits fwd_plan gives on 132 SMs, by (path, case)
EXPECTED_SPLITS = {
    ("serve", "unet_ds1"): 2, ("serve", "struct_ds1"): 2, ("serve", "unet_ds2"): 4,
    ("serve", "struct_ds2"): 4, ("serve", "vae_mid"): 1, ("serve", "large_logits"): 8,
    ("train", "unet_ds1"): 1, ("train", "struct_ds1"): 1, ("train", "unet_ds2"): 2,
    ("train", "struct_ds2"): 2, ("train", "vae_mid"): 1, ("train", "large_logits"): 8,
}


@pytest.mark.parametrize("path,case", sorted(EXPECTED_SPLITS))
def test_forward_plan_fills_the_card(path, case):
    """The grid with its split fills at least 90% of the block slots of 132
    SMs, or cannot split further; a split names the combine kernel and its
    scratch (each part's output and row max and sum)."""
    b, h, n, m, d = (CUDA_CASES if path == "serve" else TRAIN_CASES)[case][:5]
    split, scratch, kernels = attention_cuda.fwd_plan(b, h, n, m, d, 132)
    rows, keys, per_sm = attention_cuda.FWD_TILES[d]
    blocks, tiles, slots = n // rows * b * h, m // keys, per_sm * 132
    assert tiles % split == 0
    assert (blocks * split >= 0.9 * slots or split == attention_cuda.FWD_MAX_SPLIT
            or tiles % (2 * split))
    assert split == 1 or blocks * split // 2 < 0.9 * slots
    assert split == EXPECTED_SPLITS[path, case]
    assert scratch == (split * b * h * n * (d + 2) if split > 1 else 0)
    main = "flash_attn_fwd_d512" if d == 512 else "flash_attn_fwd"
    assert kernels == {main: 1, "flash_attn_fwd_combine": int(split > 1)}
