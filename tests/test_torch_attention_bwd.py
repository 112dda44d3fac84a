"""K2's backward contract and its wiring against ssl_tpu (fp32, CPU).

``flash_attn_bwd_reference`` (the recompute formula the CUDA kernels
implement) and autograd through the port's ``sdp_attention`` are held
against ``jax.vjp`` of ``ssl_tpu.ops.attention.sdp_attention``, which takes
its einsum path on the CPU; ``attention_lse_reference`` against
``jax.nn.logsumexp``.  Then the autograd function around the kernels runs
with the kernels' wrappers replaced by their plain versions, so that the
routing, the saved tensors, the packed-qkv layout's strided gradients and
the replay under ``torch.utils.checkpoint`` are held here; the kernels
themselves are held on the card (tests/test_torch_cuda.py, chip_smoke.py).
Last, the VAE decoder's remat: the same gradient with remat on and off, and
equal to ``jax.grad`` through the JAX decoder.

Tolerances: rtol 1e-4 with an atol of 1e-5 of the reference's largest
value.  The gradients are sums over up to 512 keys of products in float32,
taken in another order, and dS = P * (dP - di) subtracts two nearly equal
numbers where the output barely depends on a logit, so the error is set
against the gradient's scale, not each element's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.diffusion.vae import AutoencoderKL as JVAE
from ssl_tpu.ops import attention as jattn
from ssl_tpu_torch.diffusion.vae import AutoencoderKL
from ssl_tpu_torch.ops import attention, attention_cuda
from ssl_tpu_torch.utils.weight_port import params_from_jax
from torch_attention_cases import (BWD_ATOL, BWD_REL_L2, BWD_RTOL, TRAIN_CASES, attention_inputs,
                                   flash_attn_bwd_tf32, tf32)
from torch_diffusion_cases import VAE, close, nchw, seeded_params


def _do(b, n, h, d, seed=5):
    return torch.from_numpy(np.random.RandomState(seed).randn(b, n, h, d).astype(np.float32))


def _jax_vjp(q, k, v, do, scale):
    out, vjp = jax.vjp(lambda a, b_, c: jattn.sdp_attention(a, b_, c, scale, use_flash=True),
                       *(t.detach().numpy() for t in (q, k, v)))
    return out, vjp(do.numpy())


@pytest.mark.parametrize("d,layout,logits", [
    (16, "proj", 8.0), (64, "proj", 8.0), (16, "qkv", 8.0), (64, "qkv", 8.0), (64, "proj", 50.0),
])
def test_backward_reference_matches_jax_vjp(d, layout, logits):
    b, h, n, scale = 2, 2, 256, d ** -0.5
    q, k, v = attention_inputs(b, h, n, n, d, scale, layout, logits, seed=d)
    do = _do(b, n, h, d)
    out, grads = _jax_vjp(q, k, v, do, scale)
    o = attention.sdp_attention_reference(q, k, v, scale)
    lse = attention.attention_lse_reference(q, k, scale)
    close(o.numpy(), out)
    got = attention.flash_attn_bwd_reference(q, k, v, o, lse, do, scale)
    for g, ref in zip(got, grads):
        assert float(np.abs(np.asarray(ref)).max()) > 0
        close(g.numpy(), ref)
    # autograd through the port's plain route gives the same gradients
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    attention.sdp_attention(*leaves, scale, use_flash=True).backward(do)
    for leaf, ref in zip(leaves, grads):
        close(leaf.grad.numpy(), ref)


def _hold(got, ref):
    """chip_smoke.py's hold of K2's backward: relative L2 and elementwise."""
    ref = np.asarray(ref, dtype=np.float64)
    got = got.double().numpy()
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    ok = np.abs(got - ref) <= BWD_ATOL * np.abs(ref).max() + BWD_RTOL * np.abs(ref)
    return rel, bool(ok.all())


@pytest.mark.parametrize("d,layout,logits", [
    (d, layout, logits) for d in (16, 64) for layout in ("proj", "qkv") for logits in (8.0, 50.0)])
def test_3xtf32_backward_meets_the_hold(d, layout, logits):
    """The kernels' arithmetic (five products in 3xTF32, fp32 softmax) against
    jax.vjp of ssl_tpu's sdp_attention, within chip_smoke.py's BWD_* holds."""
    b, h, n, scale = 2, 2, 256, d ** -0.5
    q, k, v = attention_inputs(b, h, n, n, d, scale, layout, logits, seed=d + 1)
    do = _do(b, n, h, d)
    _, grads = _jax_vjp(q, k, v, do, scale)
    o = attention.sdp_attention_reference(q, k, v, scale)
    lse = attention.attention_lse_reference(q, k, scale)
    for g, ref in zip(flash_attn_bwd_tf32(q, k, v, o, lse, do, scale), grads):
        rel, elementwise = _hold(g, ref)
        assert rel <= BWD_REL_L2 and elementwise, rel


@pytest.mark.parametrize("d,layout", [(64, "proj"), (64, "qkv")])
def test_single_pass_tf32_misses_the_hold(d, layout):
    """At logits up to 50 single-pass TF32 (big·big alone) misses the
    relative-L2 hold that 3xTF32 meets: the hold tells the two apart."""
    b, h, n, scale = 2, 2, 256, d ** -0.5
    q, k, v = attention_inputs(b, h, n, n, d, scale, layout, 50.0, seed=d + 1)
    do = _do(b, n, h, d)
    _, grads = _jax_vjp(q, k, v, do, scale)
    o = attention.sdp_attention_reference(q, k, v, scale)
    lse = attention.attention_lse_reference(q, k, scale)
    rels = [_hold(g, ref)[0] for g, ref in
            zip(flash_attn_bwd_tf32(q, k, v, o, lse, do, scale, passes=1), grads)]
    assert min(rels) > BWD_REL_L2, rels


def test_tf32_rounds_as_cvt_rna():
    """Nearest of a 10-bit mantissa, ties away from zero, low 13 bits clear."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -11 + 2 ** -20, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -12, 3.0])
    assert tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0, 3.0]
    assert int((tf32(torch.randn(1000)).view(torch.int32) & 0x1FFF).abs().sum()) == 0


# The splits (dkv, dq) bwd_plan gives each training case on an H100 by the
# kernels' type: the float32 kernels fit two blocks an SM at d = 64 and
# stream 32-row tiles; the bf16 ones one block an SM and 64-row tiles.
PLAN_SPLITS = {
    torch.float32: {"unet_ds1": (1, 1), "struct_ds1": (1, 1), "unet_ds2": (2, 2),
                    "struct_ds2": (2, 2), "large_logits": (4, 4)},
    torch.bfloat16: {"unet_ds1": (1, 1), "struct_ds1": (1, 1), "unet_ds2": (1, 1),
                     "struct_ds2": (2, 2), "large_logits": (4, 4)}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_backward_plan_fills_the_card(case, dtype):
    """bwd_plan on an H100's 132 SMs: at d = 64 and 128 the dkv and dq grids,
    with their splits, fill at least 90% of the block slots or cannot split
    further; at d = 512 the scratch holds P and dS (in the kernels' type)."""
    b, h, n, m, d = TRAIN_CASES[case][:5]
    dkv, dq, scratch, kernels = attention_cuda.bwd_plan(b, h, n, m, d, 132, dtype)
    sfx = attention_cuda.SUFFIX[dtype]
    if d == 512:
        assert (dkv, dq, scratch) == (1, 1, 2 * b * h * n * m)
        assert set(kernels) == {f"flash_attn_bwd_{k}{sfx}" for k in ("p_ds", "dkv_mm", "dq_mm")}
        return
    if dtype == torch.bfloat16:
        block, rows, per_sm = (attention_cuda.BWD_BLOCK_ROWS_BF16[d],
                               attention_cuda.BWD_STREAM_ROWS_BF16[d],
                               attention_cuda.BWD_BLOCKS_PER_SM_BF16[d])
    else:
        block, rows, per_sm = (attention_cuda.BWD_BLOCK_ROWS[d], attention_cuda.BWD_STREAM_ROWS[d],
                               attention_cuda.BWD_BLOCKS_PER_SM[d])
    for f, (split, blocks, tiles) in enumerate(((dkv, m // block[0] * b * h, n // rows[0]),
                                                (dq, n // block[1] * b * h, m // rows[1]))):
        slots = per_sm[f] * 132
        assert tiles % split == 0
        assert (blocks * split >= 0.9 * slots or split == attention_cuda.BWD_MAX_SPLIT
                or tiles % (2 * split))
        assert split == 1 or blocks * split // 2 < 0.9 * slots
    assert scratch == ((2 * dkv * b * m * h * d if dkv > 1 else 0)
                       + (dq * b * n * h * d if dq > 1 else 0))
    assert kernels[f"flash_attn_bwd_sum{sfx}"] == 2 * (dkv > 1) + (dq > 1)
    assert (dkv, dq) == PLAN_SPLITS[dtype][case]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("layout,n,m", [("proj", 256, 384), ("qkv", 256, 256)])
def test_d512_halves_compose_to_the_backward_reference(dtype, layout, n, m):
    """The d = 512 backward's two halves, the plain p_ds (P and dS into the
    scratch) and the plain dkv_mm and dq_mm products on it, give
    ``flash_attn_bwd_reference``'s dq, dk and dv bit for bit, in float32 and
    with bf16's rounding points (P and dS rounded in the scratch, the
    gradients once); that function is held against ``jax.vjp`` above.
    Small widths: the composition does not depend on d."""
    b, h, d = 2, 2, 16
    scale = d ** -0.5
    q, k, v = attention_inputs(b, h, n, m, d, scale, layout, 8.0, seed=3, dtype=dtype)
    do = _do(b, n, h, d).to(dtype)
    o = attention.sdp_attention_reference(q.float(), k.float(), v.float(), scale).to(dtype)
    lse = attention.attention_lse_reference(q, k, scale)
    p_ds = attention.flash_attn_bwd_p_ds_reference(q, k, v, o, lse, do, scale)
    assert p_ds.shape == (2, b, h, n, m) and p_ds.dtype == dtype
    got = attention.flash_attn_bwd_mm_reference(p_ds, q, k, do, scale)
    want = attention.flash_attn_bwd_reference(q, k, v, o, lse, do, scale)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape and float(w.abs().max()) > 0
        assert torch.equal(g, w)
    # in float64 the products are the exact sums of the same values
    exact = attention.flash_attn_bwd_mm_reference(p_ds.double(), q.double(), k.double(),
                                                  do.double(), scale)
    for g, e in zip(got, exact):
        assert e.dtype == torch.float64
        assert float((g.double() - e).norm() / e.norm()) < (3e-3 if dtype == torch.bfloat16
                                                             else 1e-6)


@pytest.mark.parametrize("logits", [8.0, 50.0])
def test_lse_matches_jax_logsumexp(logits):
    q, k, _ = attention_inputs(1, 2, 256, 384, 32, 32 ** -0.5, "proj", logits, seed=3)
    got = attention.attention_lse_reference(q, k, 32 ** -0.5)
    ref = jax.nn.logsumexp(jnp.einsum("bnhd,bmhd->bhnm", q.numpy(), k.numpy()) * 32 ** -0.5, -1)
    assert got.shape == (1, 2, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)


@pytest.fixture
def plain_kernels(monkeypatch):
    """Route as on the card with CPU tensors: eligibility lifted, and each
    kernel wrapper replaced by its plain version, with the calls counted."""
    calls = {"fwd": 0, "fwd_lse": 0, "bwd": 0}

    def fwd(q, k, v, sm_scale, return_lse=False):
        calls["fwd_lse" if return_lse else "fwd"] += 1
        o = attention.sdp_attention_reference(q, k, v, sm_scale)
        return (o, attention.attention_lse_reference(q, k, sm_scale)) if return_lse else o

    def bwd(q, k, v, o, lse, do, sm_scale):
        calls["bwd"] += 1
        attention_cuda.check_bwd_inputs(q, k, v, o, lse, do)
        return attention.flash_attn_bwd_reference(q, k, v, o, lse, do, sm_scale)

    monkeypatch.setattr(attention, "flash_eligible", lambda n, m, use_flash, device: use_flash)
    monkeypatch.setattr(attention_cuda, "flash_attn_fwd_cuda", fwd)
    monkeypatch.setattr(attention_cuda, "flash_attn_bwd_cuda", bwd)
    return calls


def test_packed_qkv_gradient_reaches_the_packed_tensor(plain_kernels):
    """AttentionBlockQKV's layout: q, k and v are strided views of one packed
    (b, n, heads, 3, d) tensor, q and k scaled.  The function's gradients
    land on the right elements of the packed tensor."""
    packed = torch.stack(attention_inputs(1, 2, 256, 256, 64, 1.0, "qkv", 8.0, seed=4), dim=3)
    do = _do(1, 256, 2, 64)

    def run(flash):
        x = packed.clone().requires_grad_(True)
        scale = 64 ** -0.25
        out = attention.sdp_attention(x[..., 0, :] * scale, x[..., 1, :] * scale, x[..., 2, :],
                                      1.0, use_flash=flash)
        out.backward(do)
        return x.grad

    got = run(True)
    assert plain_kernels == {"fwd": 0, "fwd_lse": 1, "bwd": 1}
    with torch.no_grad():
        attention.sdp_attention(*packed.unbind(3), 1.0, use_flash=True)
    assert plain_kernels["fwd"] == 1                  # no gradient: the forward alone
    ref = run(False)                                  # the plain route: autograd through einsum
    assert float(ref[..., 2, :].abs().max()) > 0 and float(ref[..., 0, :].abs().max()) > 0
    close(got.numpy(), ref.numpy())


def test_checkpoint_replays_the_forward_kernel(plain_kernels):
    """Under torch.utils.checkpoint the forward runs twice (the replay saves
    a fresh lse) and the backward once; the gradient is unchanged."""
    q, k, v = attention_inputs(1, 2, 256, 256, 64, 0.125, "proj", 8.0, seed=6)
    do = _do(1, 256, 2, 64)
    grads = []
    for remat in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn = lambda a, b_, c: attention.sdp_attention(a, b_, c, 0.125, use_flash=True)  # noqa: E731
        out = (torch.utils.checkpoint.checkpoint(fn, *leaves, use_reentrant=False) if remat
               else fn(*leaves))
        out.backward(do)
        grads.append([t.grad for t in leaves])
    assert plain_kernels == {"fwd": 0, "fwd_lse": 3, "bwd": 2}
    for a, b_ in zip(*grads):
        assert torch.equal(a, b_)


@pytest.fixture(scope="module")
def decoder_pair():
    rng = np.random.RandomState(9)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    z = rng.randn(2, 16, 16, 4).astype(np.float32)
    j_vae = JVAE(**VAE)
    vp = seeded_params(j_vae, img, seed=31)
    w = rng.randn(2, 32, 32, 3).astype(np.float32)        # a fixed linear read-out

    def loss(z_):
        return jnp.sum(j_vae.apply({"params": vp}, z_, method=j_vae.decode) * w)
    return z, vp, w, jax.grad(loss)(jnp.asarray(z))


@pytest.mark.parametrize("remat,skip", [(False, 0), (True, 0), (True, 1)])
def test_decoder_remat_gradient_matches_jax(decoder_pair, remat, skip):
    """remat_decoder_blocks on (every block replayed, or with the lowest
    stage exempt) and off give one gradient, equal to jax.grad through the
    JAX decoder (whose remat is on, its default)."""
    z, vp, w, ref = decoder_pair
    vae = AutoencoderKL(**VAE, remat_decoder_blocks=remat, remat_skip_lowres=skip)
    vae.load_state_dict(params_from_jax("AutoencoderKL", vp))
    replays = []
    attn, forward = vae.decoder.mid.attn_1, vae.decoder.mid.attn_1.forward
    attn.forward = lambda x: (replays.append(1), forward(x))[1]   # the replay skips hooks
    zt = nchw(z).requires_grad_(True)
    (vae.decode(zt) * nchw(w)).sum().backward()
    assert len(replays) == (2 if remat else 1)         # the mid attention always replays
    close(zt.grad.numpy().transpose(0, 2, 3, 1), ref)
    with torch.no_grad():
        vae.decode(zt)
    assert len(replays) == (3 if remat else 2)         # no checkpoint without grad
