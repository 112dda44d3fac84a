"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere:
a CUDA kernel has no CPU mode.  The file imports no JAX, so it also runs on
a machine without JAX; ``--noconftest`` keeps ``tests/conftest.py``, which
sets JAX up, out of the run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

K2 (flash attention) is held against ``sdp_attention_reference`` at the
diffusion serving path's shapes (``tests/torch_attention_cases.py``) with
rtol 1e-4 and an atol of 1e-5 of the output's largest value: both sum in
float32, in another order.  K2's backward (dkv and dq) and the forward's
lse are held at the training path's shapes against
``flash_attn_bwd_reference`` with rtol 1e-3 and an atol of 1e-4 of each
gradient's largest value, and a relative L2 of 1e-4: dS = P * (dP - di)
subtracts nearly equal numbers where a logit barely matters, so single
elements carry that cancellation's rounding on the gradient's own scale.
The forward's two products and the backward's five run as 3xTF32 on the
tensor cores, under the same holds; two launches on the same inputs give
bit-identical outputs (K1 too), with and without a split key loop.

Tolerances (K1): count exact; l1 rel 1e-4 and kl rel 1e-3, the contract of
tests/test_ssg_pallas.py:30-31 (sums taken in another order); the (b, h, w)
maps ``MAP_RTOL`` with an atol of 1e-6 of the map's largest value; d_sr rtol
1e-4 (tests/test_ssg_pallas.py:48) with ``grad_atol``."""

import numpy as np
import pytest
import torch
from torch_attention_cases import CUDA_CASES, TRAIN_CASES, attention_inputs
from torch_ssg_cases import CASES, MAP_RTOL, case_inputs, grad_atol

from ssl_tpu_torch.ops import attention_cuda, ssg_cuda
from ssl_tpu_torch.ops.attention import (attention_lse_reference, flash_attn_bwd_reference,
                                         sdp_attention, sdp_attention_reference)
from ssl_tpu_torch.ops.ssg import SSGConfig, ssl_loss_dense_bwd, ssl_loss_sums_reference


@pytest.fixture
def cuda_case(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the K1 kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sr, gt, mask, search, window, sigma = case_inputs(request.param)
    return ([torch.from_numpy(a).cuda() for a in (sr, gt, mask)],
            SSGConfig(search=search, window=window, sigma=sigma), request.param)


@pytest.mark.cuda
@pytest.mark.parametrize("cuda_case", sorted(CASES), indirect=True)
def test_k1_kernel_matches_plain_on_card(cuda_case):
    args, cfg, case = cuda_case
    got = [v.cpu().numpy() for v in ssg_cuda.ssg_loss_fwd_cuda(*args, cfg)]
    ref = [v.cpu().numpy() for v in ssl_loss_sums_reference(*args, cfg)]
    assert float(got[2]) == float(ref[2])
    assert abs(float(got[0]) - float(ref[0])) <= 1e-4 * abs(float(ref[0]))
    assert abs(float(got[1]) - float(ref[1])) <= 1e-3 * abs(float(ref[1]))
    for name, g, r in zip(("inv_sr", "inv_gt", "a_map", "b_map"), got[3:], ref[3:]):
        np.testing.assert_allclose(g, r, rtol=MAP_RTOL[case], atol=1e-6 * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("cuda_case", sorted(CASES), indirect=True)
def test_k1_gradient_matches_plain_on_card(cuda_case):
    """d_sr through the autograd function (kernel forward, one launch) against
    the backward fed the plain forward's maps."""
    (sr, gt, mask), cfg, _ = cuda_case
    s = sr.clone().requires_grad_(True)
    before = ssg_cuda.launches
    l1, kl, _ = ssg_cuda.ssl_loss_sums(s, gt, mask, cfg)
    (l1 + 0.5 * kl).backward()
    assert ssg_cuda.launches == before + 1
    ref = ssl_loss_sums_reference(sr, gt, mask, cfg)
    one, half = torch.ones((), device="cuda"), torch.full((), 0.5, device="cuda")
    d_ref = ssl_loss_dense_bwd(sr, gt, mask, ref[3], ref[4], one, half, cfg,
                               a_map=ref[5], b_map=ref[6]).cpu().numpy()
    np.testing.assert_allclose(s.grad.cpu().numpy(), d_ref, rtol=1e-4, atol=grad_atol(d_ref))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the K2 kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_k2_kernel_matches_plain_on_card(card, case):
    b, heads, n, m, d, scale, layout, logits = CUDA_CASES[case]
    q, k, v = attention_inputs(b, heads, n, m, d, scale, layout, logits, device="cuda")
    before = attention_cuda.launches
    got = sdp_attention(q, k, v, scale, use_flash=True)
    assert attention_cuda.launches == before + 1
    ref = sdp_attention_reference(q, k, v, scale)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (b, n, heads, d)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_k2_backward_matches_plain_on_card(card, case):
    """A gradient through an eligible call: one forward launch with lse,
    one backward call (dkv and dq), against the plain recompute formula."""
    b, heads, n, m, d, scale, layout, logits = TRAIN_CASES[case]
    q, k, v = attention_inputs(b, heads, n, m, d, scale, layout, logits, device="cuda")
    do = torch.randn((b, n, heads, d), generator=torch.Generator(device="cuda").manual_seed(11),
                     device="cuda")
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    before = (attention_cuda.launches, attention_cuda.bwd_launches)
    sdp_attention(*leaves, scale, use_flash=True).backward(do)
    assert (attention_cuda.launches, attention_cuda.bwd_launches) == (before[0] + 1,
                                                                      before[1] + 1)
    o, lse = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
    ref_lse = attention_lse_reference(q, k, scale)
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(), rtol=1e-5, atol=1e-5)
    ref = flash_attn_bwd_reference(q, k, v, sdp_attention_reference(q, k, v, scale), ref_lse, do,
                                   scale)
    torch.cuda.synchronize()
    for name, leaf, r in zip(("dq", "dk", "dv"), leaves, ref):
        g = leaf.grad
        assert float((g - r).norm() / r.norm()) <= 1e-4, name
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=1e-3,
                                   atol=1e-4 * float(r.abs().max()), err_msg=name)


@pytest.mark.cuda
def test_k2_raises_instead_of_falling_back(card):
    """An eligible CUDA call never takes the plain path: a gradient goes
    through the backward kernels, and a shape the kernels do not take
    raises."""
    q, k, v = attention_inputs(1, 2, 512, 512, 64, 0.125, "proj", 8.0, device="cuda")
    before = (attention_cuda.launches, attention_cuda.bwd_launches)
    sdp_attention(q.clone().requires_grad_(True), k, v, 0.125, use_flash=True).sum().backward()
    assert (attention_cuda.launches, attention_cuda.bwd_launches) == (before[0] + 1,
                                                                      before[1] + 1)
    q48, k48, v48 = (t[..., :48] for t in attention_inputs(1, 2, 512, 512, 64, 0.125, "proj",
                                                            8.0, device="cuda"))
    with pytest.raises(ValueError, match="head width 48"):
        sdp_attention(q48, k48, v48, 0.125, use_flash=True)
    with pytest.raises(ValueError, match="head width 48"):
        sdp_attention(q48.clone().requires_grad_(True), k48, v48, 0.125, use_flash=True)
    assert attention_cuda.launches == before[0] + 1
    with torch.no_grad():
        sdp_attention(q, k, v, 0.125, use_flash=True)
    assert (attention_cuda.launches, attention_cuda.bwd_launches) == (before[0] + 2,
                                                                      before[1] + 1)


def _bwd_inputs(case):
    b, heads, n, m, d, scale, layout, logits = TRAIN_CASES[case]
    q, k, v = attention_inputs(b, heads, n, m, d, scale, layout, logits, device="cuda")
    do = torch.randn((b, n, heads, d), generator=torch.Generator(device="cuda").manual_seed(11),
                     device="cuda")
    o, lse = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
    return q, k, v, o, lse, do, scale


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_k2_backward_repeats_bit_for_bit(card, case):
    """No atomics, fixed summation orders (split parts added in order): two
    launches on the same inputs give identical dq, dk and dv."""
    args = _bwd_inputs(case)
    first = attention_cuda.flash_attn_bwd_cuda(*args)
    second = attention_cuda.flash_attn_bwd_cuda(*args)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b_), name


@pytest.mark.cuda
@pytest.mark.parametrize("case,kernels", [
    ("vae_mid", {"flash_attn_bwd_p_ds": 1, "flash_attn_bwd_dkv_mm": 1, "flash_attn_bwd_dq_mm": 1}),
    ("struct_ds2", {"flash_attn_bwd_dkv": 1, "flash_attn_bwd_dq": 1, "flash_attn_bwd_sum": 3}),
])
def test_k2_backward_paths_match_plain(card, case, kernels):
    """d = 512 goes through P and dS in scratch and two tensor-core products;
    struct_ds2's small grid through split loops and the ordered sum.  Each
    launches the kernels its plan names and matches the plain recompute
    formula."""
    q, k, v, o, lse, do, scale = _bwd_inputs(case)
    before = dict(attention_cuda.bwd_kernel_launches)
    got = attention_cuda.flash_attn_bwd_cuda(q, k, v, o, lse, do, scale)
    launched = {n: c - before[n] for n, c in attention_cuda.bwd_kernel_launches.items()
                if c != before[n]}
    assert launched == kernels
    ref = flash_attn_bwd_reference(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert float((g - r).norm() / r.norm()) <= 1e-4, name
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=1e-3,
                                   atol=1e-4 * float(r.abs().max()), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_k2_forward_repeats_bit_for_bit(card, case):
    """No atomics, fixed summation orders (split parts merged in order): two
    launches on the same inputs give identical o and lse."""
    b, heads, n, m, d, scale, layout, logits = CUDA_CASES[case]
    q, k, v = attention_inputs(b, heads, n, m, d, scale, layout, logits, device="cuda")
    first = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
    second = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("o", "lse"), first, second):
        assert torch.equal(a, b_), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unet_ds2", "struct_ds2", "vae_mid", "large_logits"])
def test_k2_forward_paths_match_plain(card, case):
    """The key split with its ordered combine (unet_ds2, struct_ds2,
    large_logits) and the d = 512 kernel (vae_mid) each launch the kernels
    ``fwd_plan`` names and match the plain version, o and lse."""
    b, heads, n, m, d, scale, layout, logits = CUDA_CASES[case]
    q, k, v = attention_inputs(b, heads, n, m, d, scale, layout, logits, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split, _, plan = attention_cuda.fwd_plan(b, heads, n, m, d, sms)
    before = dict(attention_cuda.fwd_kernel_launches)
    o, lse = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
    launched = {n_: c - before[n_] for n_, c in attention_cuda.fwd_kernel_launches.items()
                if c != before[n_]}
    assert launched == {n_: c for n_, c in plan.items() if c}
    assert (split > 1) == (case != "vae_mid")
    ref = sdp_attention_reference(q, k, v, scale)
    torch.cuda.synchronize()
    np.testing.assert_allclose(o.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4,
                               atol=1e-5 * float(ref.abs().max()))
    np.testing.assert_allclose(lse.cpu().numpy(), attention_lse_reference(q, k, scale).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cuda_case", sorted(CASES), indirect=True)
def test_k1_repeats_bit_for_bit(cuda_case):
    args, cfg, _ = cuda_case
    first = ssg_cuda.ssg_loss_fwd_cuda(*args, cfg)
    second = ssg_cuda.ssg_loss_fwd_cuda(*args, cfg)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))
