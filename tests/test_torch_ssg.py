"""The port's SSG loss against ssl_tpu: the plain K1 forward, the analytic
backward through the autograd function, and the padding / mask helpers.

Inputs are made with numpy from a seed and fed to both packages (fp32, CPU);
``torch_ssg_cases`` says how they were chosen and why the maps' tolerances
are what they are.  The kernel itself is held against the plain version on
the card by ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ssg_cases import CASES, MAP_RTOL, case_inputs, grad_atol

from ssl_tpu.ops import ssg as jssg
from ssl_tpu_torch.ops import ssg as tssg
from ssl_tpu_torch.ops import ssg_cuda


def _case(name):
    sr, gt, mask, search, window, sigma = case_inputs(name)
    cfg_j = jssg.SSGConfig(search=search, window=window, sigma=sigma)
    cfg_t = tssg.SSGConfig(search=search, window=window, sigma=sigma)
    return sr, gt, mask, cfg_j, cfg_t


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k1_matches_jax_dense_core(case):
    """Sums, count, inverse maps and backward helper maps of the plain K1
    against ``_ssl_loss_dense_core``.  Tolerances: count exact; l1 rel 1e-4
    and kl rel 1e-3 (tests/test_ssg_pallas.py:30-31: the sums are taken in
    another order); maps MAP_RTOL with atol 1e-6 of the map's largest value
    (entries that small are sums of cancelling signed terms)."""
    sr, gt, mask, cfg_j, cfg_t = _case(case)
    ref = [np.asarray(v) for v in jssg._ssl_loss_dense_core(
        jnp.asarray(sr), jnp.asarray(gt), jnp.asarray(mask), cfg_j)]
    got = [v.numpy() for v in tssg.ssl_loss_sums_reference(
        torch.from_numpy(sr), torch.from_numpy(gt), torch.from_numpy(mask), cfg_t)]
    assert float(got[2]) == float(ref[2])
    assert abs(float(got[0]) - float(ref[0])) <= 1e-4 * abs(float(ref[0]))
    assert abs(float(got[1]) - float(ref[1])) <= 1e-3 * abs(float(ref[1]))
    for name, g, r in zip(("inv_sr", "inv_gt", "a_map", "b_map"), got[3:], ref[3:]):
        np.testing.assert_allclose(g, r, rtol=MAP_RTOL[case], atol=1e-6 * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.parametrize("with_maps", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_jax_grad(case, with_maps):
    """d_sr of l1 + 0.5 kl against ``jax.grad`` of ``ssl_loss_dense_batched``
    (rtol 1e-4 as tests/test_ssg_pallas.py:48, atol ``grad_atol``).  With the maps the
    gradient goes through the autograd function (which feeds the forward's
    a_map/b_map to the backward); without them the backward runs its own T
    pass."""
    sr, gt, mask, cfg_j, cfg_t = _case(case)

    def loss_j(s):
        l1, kl, _ = jssg.ssl_loss_dense_batched(s, jnp.asarray(gt), jnp.asarray(mask), cfg_j)
        return l1 + 0.5 * kl

    ref = np.asarray(jax.grad(loss_j)(jnp.asarray(sr)))
    srt, gtt, maskt = (torch.from_numpy(a) for a in (sr, gt, mask))
    if with_maps:
        s = srt.clone().requires_grad_(True)
        l1, kl, _ = ssg_cuda.ssl_loss_sums(s, gtt, maskt, cfg_t)
        (l1 + 0.5 * kl).backward()
        got = s.grad.numpy()
    else:
        fwd = tssg.ssl_loss_sums_reference(srt, gtt, maskt, cfg_t)
        got = tssg.ssl_loss_dense_bwd(srt, gtt, maskt, fwd[3], fwd[4], torch.tensor(1.0),
                                      torch.tensor(0.5), cfg_t).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=grad_atol(ref))


@pytest.mark.parametrize("pad", [1, 4, 12])
def test_reflect_pad_and_adjoint_match_jax(pad):
    """reflect_pad_2d against jnp.pad(mode='reflect') and its adjoint against
    jax.vjp, exactly (pure data movement; the adjoint adds at most two terms
    per element, so the order cannot change the result)."""
    rng = np.random.RandomState(pad)
    img = rng.rand(2, 3, 13, 15).astype(np.float32)
    padded, vjp = jax.vjp(lambda x: jssg.reflect_pad_2d(x, pad), jnp.asarray(img))
    np.testing.assert_array_equal(tssg.reflect_pad_2d(torch.from_numpy(img), pad).numpy(),
                                  np.asarray(padded))
    g = rng.rand(*padded.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(g))
    got = tssg.reflect_pad_2d_adjoint(torch.from_numpy(g), pad).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stride", [0, 1, 3, 4])
def test_apply_mask_stride_matches_jax(stride):
    mask = (np.random.RandomState(stride).rand(2, 17, 19) < 0.5).astype(np.float32)
    ref = np.asarray(jssg.apply_mask_stride(jnp.asarray(mask), stride))
    np.testing.assert_array_equal(tssg.apply_mask_stride(torch.from_numpy(mask), stride).numpy(),
                                  ref)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors ssl_loss_sums runs the plain version (no launch)."""
    sr, gt, mask, _, cfg = _case("small")
    before = ssg_cuda.launches
    got = ssg_cuda.ssl_loss_sums(torch.from_numpy(sr), torch.from_numpy(gt),
                                 torch.from_numpy(mask), cfg)
    ref = tssg.ssl_loss_sums_reference(torch.from_numpy(sr), torch.from_numpy(gt),
                                       torch.from_numpy(mask), cfg)
    for g, r in zip(got, ref[:3]):
        assert torch.equal(g, r)
    assert ssg_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors_and_bad_inputs():
    sr, gt, mask, _, cfg = _case("small")
    srt, gtt, maskt = (torch.from_numpy(a) for a in (sr, gt, mask))
    with pytest.raises(ValueError, match="CUDA"):
        ssg_cuda.ssg_loss_fwd_cuda(srt, gtt, maskt, cfg)
    with pytest.raises(ValueError, match="mask"):
        ssg_cuda.ssl_loss_sums(srt, gtt, maskt[:, None], cfg)
    with pytest.raises(TypeError, match="float32"):
        ssg_cuda.ssl_loss_sums(srt.double(), gtt.double(), maskt, cfg)
    with pytest.raises(ValueError, match="reflect padding"):
        ssg_cuda.ssl_loss_sums(srt[:, :, :4, :4].contiguous(), gtt[:, :, :4, :4].contiguous(),
                               maskt[:, :4, :4].contiguous(), cfg)


def test_bf16_knobs_raise():
    cfg = tssg.SSGConfig(search=9, window=5, q_store_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="bf16"):
        tssg.check_config(cfg)
    with pytest.raises(NotImplementedError, match="bf16"):
        tssg.check_config(tssg.SSGConfig(stream_dtype="bfloat16"))

