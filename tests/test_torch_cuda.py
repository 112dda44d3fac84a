"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere:
a CUDA kernel has no CPU mode.  The file imports no JAX, so it also runs on
a machine without JAX; ``--noconftest`` keeps ``tests/conftest.py``, which
sets JAX up, out of the run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances (K1): count exact; l1 rel 1e-4 and kl rel 1e-3, the contract of
tests/test_ssg_pallas.py:30-31 (sums taken in another order); the (b, h, w)
maps ``MAP_RTOL`` with an atol of 1e-6 of the map's largest value; d_sr rtol
1e-4 (tests/test_ssg_pallas.py:48) with ``grad_atol``."""

import numpy as np
import pytest
import torch
from torch_ssg_cases import CASES, MAP_RTOL, case_inputs, grad_atol

from ssl_tpu_torch.ops import ssg_cuda
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
