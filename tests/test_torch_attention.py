"""The port's attention routing against ssl_tpu/ops/attention.py (fp32, CPU).

On the CPU both packages take the plain path for every shape, so the plain
version is held against the JAX function with the flash switch on: self-
attention at n = 512 (an eligible length), cross-attention over the 77-token
context, and the head-major packed qkv of ``AttentionBlockQKV``.  The
eligibility rule is held against JAX's with the TPU backend in place of
CUDA.  Tolerance: rtol 1e-5 with an atol of 1e-6 of the reference's largest
value (the same float32 einsums and softmax, summed in another order)."""

import jax
import numpy as np
import pytest
import torch

from ssl_tpu.diffusion.unet import AttentionBlockQKV as JAttentionBlockQKV
from ssl_tpu.ops import attention as jattn
from ssl_tpu_torch.diffusion.unet import AttentionBlockQKV
from ssl_tpu_torch.ops import attention, attention_cuda
from torch_attention_cases import attention_inputs


def close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("b,heads,n,m,d,layout", [
    (2, 4, 512, 512, 32, "proj"),       # UNet self-attention at an eligible length
    (2, 4, 256, 77, 32, "proj"),        # cross-attention over the text context
    (1, 2, 512, 512, 16, "qkv"),        # strided views of a packed qkv
])
def test_plain_attention_matches_jax(b, heads, n, m, d, layout):
    scale = d ** -0.5
    q, k, v = attention_inputs(b, heads, n, m, d, scale, layout, 8.0, seed=n + m)
    before = attention_cuda.launches
    got = attention.sdp_attention(q, k, v, scale, use_flash=True)
    assert attention_cuda.launches == before          # the CPU never reaches the kernel
    ref = jattn.sdp_attention(*(t.numpy() for t in (q, k, v)), scale, use_flash=True)
    assert got.shape == (b, n, heads, d)
    close(got.numpy(), ref)


def test_attention_block_qkv_matches_jax():
    """The module: GroupNorm, the packed qkv projection, q and k each scaled
    by d^-1/4 with sm_scale 1, the output projection and the residual."""
    b, c, hh, ww, heads = 1, 64, 16, 32, 4
    rng = np.random.RandomState(3)
    x = rng.randn(b, hh, ww, c).astype(np.float32)
    params = {"norm": {"scale": 1 + 0.1 * rng.randn(c), "bias": 0.1 * rng.randn(c)},
              "qkv": {"kernel": rng.randn(c, 3 * c) / 8, "bias": 0.1 * rng.randn(3 * c)},
              "proj_out": {"kernel": rng.randn(c, c) / 8, "bias": 0.1 * rng.randn(c)}}
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    ref = JAttentionBlockQKV(heads, use_flash_attention=True).apply({"params": params}, x)

    block = AttentionBlockQKV(c, heads, use_flash_attention=True)
    with torch.no_grad():
        block.norm.weight.copy_(torch.from_numpy(params["norm"]["scale"]))
        block.norm.bias.copy_(torch.from_numpy(params["norm"]["bias"]))
        for name in ("qkv", "proj_out"):
            layer = getattr(block, name)
            layer.weight.copy_(torch.from_numpy(params[name]["kernel"].T[..., None]))
            layer.bias.copy_(torch.from_numpy(params[name]["bias"]))
        got = block(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    close(got.numpy().transpose(0, 2, 3, 1), ref)


@pytest.mark.parametrize("n,m,use_flash", [
    (512, 512, True), (4096, 4096, True), (1024, 1024, True), (256, 256, True),
    (640, 77, True), (384, 512, True), (512, 640, True), (520, 520, True), (4096, 4096, False),
])
def test_eligibility_is_the_jax_rule_with_cuda_for_tpu(monkeypatch, n, m, use_flash):
    monkeypatch.setattr(jattn.jax, "default_backend", lambda: "tpu")
    want = jattn.flash_eligible(n, m, use_flash)
    assert attention.flash_eligible(n, m, use_flash, "cuda") == want
    assert attention.flash_eligible(n, m, use_flash, torch.device("cuda", 0)) == want
    assert not attention.flash_eligible(n, m, use_flash, "cpu")


def test_an_eligible_call_never_falls_back(monkeypatch):
    """Routing as on the card, with CPU tensors standing in: without a
    gradient the call goes to the forward kernel's wrapper, which refuses
    what it cannot launch instead of returning the plain result; with one it
    goes through the autograd function, whose backward goes to the backward
    kernels' wrapper (the forward's output stood in for here), which refuses
    CPU tensors in the same way."""
    monkeypatch.setattr(attention, "flash_eligible", lambda *a: True)
    q, k, v = attention_inputs(1, 2, 512, 512, 64, 0.125, "proj", 8.0)
    with torch.no_grad(), pytest.raises(ValueError, match="flash_attn_fwd_cuda takes CUDA"):
        attention.sdp_attention(q, k, v, 0.125, use_flash=True)
    with pytest.raises(ValueError, match="flash_attn_fwd_cuda takes CUDA"):
        attention.sdp_attention(q.clone().requires_grad_(True), k, v, 0.125, use_flash=True)

    def forward(q, k, v, sm_scale, return_lse=False):
        assert return_lse                                   # the backward needs it
        return (attention.sdp_attention_reference(q, k, v, sm_scale),
                attention.attention_lse_reference(q, k, sm_scale))

    monkeypatch.setattr(attention_cuda, "flash_attn_fwd_cuda", forward)
    out = attention.sdp_attention(q.requires_grad_(True), k, v, 0.125, use_flash=True)
    with pytest.raises(ValueError, match="flash_attn_bwd_cuda takes CUDA"):
        out.square().sum().backward()


def test_plain_path_keeps_its_gradient_on_cpu():
    q, k, v = (t.requires_grad_(True) for t in attention_inputs(1, 2, 512, 512, 16, 0.25,
                                                                "proj", 8.0))
    attention.sdp_attention(q, k, v, 0.25, use_flash=True).square().sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0) for t in (q, k, v))


@pytest.mark.parametrize("change,error", [
    (lambda q, k, v: (q[..., :48], k[..., :48], v[..., :48]), "head width 48"),
    (lambda q, k, v: (q[:, :500], k, v), "multiples of 128"),
    (lambda q, k, v: (q.double(), k, v), "float32"),
    (lambda q, k, v: (q, k.transpose(1, 3).contiguous().transpose(1, 3), v), "unit stride"),
    (lambda q, k, v: (q, k[:, :, :1], v[:, :, :1]), "differ in b, heads or d"),
])
def test_kernel_inputs_are_checked(change, error):
    q, k, v = attention_inputs(1, 2, 512, 512, 64, 0.125, "proj", 8.0)
    with pytest.raises((ValueError, TypeError), match=error):
        attention_cuda.check_inputs(*change(q, k, v))


def test_kernel_takes_strided_views_as_they_are():
    """The packed-qkv views and the projections' (b, n, heads·d) views pass
    the checks without a copy: only d needs unit stride."""
    for layout in ("proj", "qkv"):
        q, k, v = attention_inputs(1, 4, 512, 512, 64, 0.125, layout, 8.0)
        attention_cuda.check_inputs(q, k, v)
    assert not v.is_contiguous()
