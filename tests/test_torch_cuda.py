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

K2's bf16 kernels (``compute_dtype: bfloat16``) are held against the
float32 plain version on the same bf16 inputs upcast, by the holds of
``tests/torch_attention_cases.py`` (BF16_*): the forward within 5e-3
relative L2 (o is rounded to bf16 once, P where it enters P·V) and at most
1.5 times the plain bf16 route's error; the backward, fed the float32
reference's o (in bf16) and lse, within 1e-2 relative L2 for each of dq, dk
and dv and at most 1.5 times the error of ``flash_attn_bwd_reference`` on
the bf16 inputs (the same rounding points); both bit for bit on repeat.
The d = 512 backward's two products (dkv_mm, dq_mm) are also held alone on
a bf16 P/dS scratch: within 2e-3 relative L2 of the float64 products of the
same bf16 values and at most 1.1 times cuBLAS's error on them (MM_*).

Tolerances (K1): count exact; l1 rel 1e-4 and kl rel 1e-3, the contract of
tests/test_ssg_pallas.py:30-31 (sums taken in another order); the (b, h, w)
maps ``MAP_RTOL`` with an atol of 1e-6 of the map's largest value; d_sr rtol
1e-4 (tests/test_ssg_pallas.py:48) with ``grad_atol``."""

import numpy as np
import pytest
import torch
from torch_attention_cases import (BF16_BWD_REL_L2, BF16_FWD_REL_L2, BF16_PLAIN_RATIO,
                                   CUDA_CASES, MM_LIBRARY_RATIO, MM_ODD_CASE, MM_REL_L2,
                                   TRAIN_CASES, attention_inputs, mm_library_calls)
from torch_ssg_cases import CASES, MAP_RTOL, case_inputs, grad_atol

from ssl_tpu_torch.ops import attention_cuda, ssg_cuda
from ssl_tpu_torch.ops.attention import (attention_lse_reference, flash_attn_bwd_mm_reference,
                                         flash_attn_bwd_p_ds_reference, flash_attn_bwd_reference,
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


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [(1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("cuda_case", ["small"], indirect=True)
def test_k1_bf16_modes_match_plain_on_card(cuda_case, mode):
    """K1's bf16 modes (stream, store, both) against the plain version in
    the same mode: the count exact, the inverse maps as in float32 (they sum
    the float32 q), l1 and kl rel 1e-3, and a_map and b_map within the plain
    version's bounds with its ties free (``chip_smoke.near_ties``: a sign of
    x - y within rounding of the other side, which the bf16 stream makes
    common by rounding SR and GT to the same values; with the bf16 store, a q
    within rounding of a bf16 rounding boundary, which moves x or y by a bf16
    ulp); each launch counted under its mode."""
    from chip_smoke import near_ties
    args, cfg, case = cuda_case
    cfg = cfg._replace(stream_dtype="bfloat16" if mode[0] else "float32",
                       q_store_dtype="bfloat16" if mode[1] else "float32")
    before = ssg_cuda.launches_by_mode.get(mode, 0)
    got = ssg_cuda.ssg_loss_fwd_cuda(*args, cfg)
    assert ssg_cuda.launches_by_mode[mode] == before + 1
    ref = ssl_loss_sums_reference(*args, cfg)
    assert float(got[2]) == float(ref[2])
    for i in (0, 1):
        assert abs(float(got[i]) - float(ref[i])) <= 1e-3 * abs(float(ref[i]))
    rtol = MAP_RTOL[case]
    for name, g, r in zip(("inv_sr", "inv_gt"), got[3:5], ref[3:5]):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=rtol,
                                   atol=1e-6 * float(r.abs().max()), err_msg=name)
    _, _, a_lo, a_hi, x_sum, b_free, x16, y16, _ = near_ties(args[0], args[1], ref, cfg)
    slack = rtol * x_sum + x16
    assert bool(((got[5] >= a_lo - slack) & (got[5] <= a_hi + slack)).all()), "a_map"
    b_tol = rtol * ref[6].abs() + 1e-6 * float(ref[6].abs().max()) + y16 + b_free
    assert bool(((got[6] - ref[6]).abs() <= b_tol).all()), "b_map"


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
@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
@pytest.mark.parametrize("cuda_case", ["small"], indirect=True)
def test_k1_store_kernels_alone_match_plain_on_card(cuda_case, stream):
    """With the bf16 q store, K1's walk and stream alone
    (``chip_smoke.hold_k1_stack``: the stack within one bf16 ulp of
    ``q_stack_reference``'s, the stream on the walk's stack against
    ``q_stream_reference``, each bit for bit on a repeat), and one call of
    the forward launching each kernel once."""
    from chip_smoke import hold_k1_stack
    args, cfg, case = cuda_case
    cfg = cfg._replace(q_store_dtype="bfloat16", stream_dtype=stream)
    out = hold_k1_stack(case, *args, cfg, MAP_RTOL[case])
    assert out["stack_flip_share"] <= 1e-2
    before = (ssg_cuda.launches, ssg_cuda.stream_launches)
    ssg_cuda.ssg_loss_fwd_cuda(*args, cfg)
    assert (ssg_cuda.launches, ssg_cuda.stream_launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("d,split", [(64, 2), (128, 4), (512, 2), (64, 8)])
def test_combine_bf16_alone_matches_plain_on_card(card, d, split):
    """``flash_attn_fwd_combine_bf16`` alone on seeded parts against
    ``flash_attn_fwd_combine_reference`` (``chip_smoke.hold_combine_bf16``:
    o within a bf16 rounding, lse 1e-5, bit for bit on a repeat)."""
    from chip_smoke import hold_combine_bf16
    out = hold_combine_bf16(f"d{d}_split{split}", 2, 2, 256, d, split)
    assert out["repeat_bit_for_bit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cuda_case", sorted(CASES), indirect=True)
def test_k1_repeats_bit_for_bit(cuda_case):
    args, cfg, _ = cuda_case
    first = ssg_cuda.ssg_loss_fwd_cuda(*args, cfg)
    second = ssg_cuda.ssg_loss_fwd_cuda(*args, cfg)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


@pytest.mark.cuda
def test_cli_tensor_helpers_on_card(card):
    """The CLI's tensor paths on the card equal their CPU results: the edge
    mask (integer arithmetic in float32, exact), reflect padding, and the
    prefetcher's copies (side stream, pinned memory)."""
    from ssl_tpu_torch.data.loader import device_prefetch
    from ssl_tpu_torch.models.sr_model import pad_reflect
    from ssl_tpu_torch.ops.edge_mask import edge_mask_torch
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.rand(2, 3, 37, 41).astype(np.float32))
    img[:, :, 5:20, 8:30] = 0.9
    assert torch.equal(edge_mask_torch(img.cuda(), 20.0).cpu(), edge_mask_torch(img, 20.0))
    assert torch.equal(pad_reflect(img.cuda(), 11, 7).cpu(), pad_reflect(img, 11, 7))
    batches = [{"lq": torch.rand(2, 3, 8, 8).pin_memory(), "lq_path": ["a", "b"]}
               for _ in range(3)]
    got = list(device_prefetch(batches, "cuda"))
    assert [b["lq_path"] for b in got] == [b["lq_path"] for b in batches]
    for g, b in zip(got, batches):
        assert g["lq"].is_cuda and torch.equal(g["lq"].cpu(), b["lq"])


@pytest.mark.cuda
def test_diffusion_cli_mini_step_on_card(card, tmp_path, capsys):
    """One mini-step of the StableSR-SSL training CLI on the card: the loader,
    the host degrader at scale 1 and the train step, with K1 launched once
    and the losses finite."""
    import json

    from scipy.io import savemat

    from ssl_tpu_torch.diffusion import main as dmain
    from ssl_tpu_torch.utils.png import encode_png
    rng = np.random.RandomState(0)
    for d in ("gt", "mask"):
        (tmp_path / d).mkdir()
    for i in range(2):
        (tmp_path / "gt" / f"{i}.png").write_bytes(
            encode_png((rng.rand(48, 48, 3) * 255).astype(np.uint8)))
        savemat(str(tmp_path / "mask" / f"{i}.mat"),
                {"mat": (rng.rand(48, 48) < 0.2).astype(np.float64)})
    cfg = {"model": {"timesteps": 50, "context_dim": 32,
                     "unet": {"model_channels": 32, "num_res_blocks": 1, "channel_mult": [1, 2],
                              "attention_resolutions": [2], "num_head_channels": 8},
                     "first_stage": {"embed_dim": 4, "ch": 16, "ch_mult": [1, 2, 2, 2],
                                     "num_res_blocks": 1}},
           "sslopt": {"kernel_size_search": 9, "kernel_size_window": 5, "sigma": 0.1},
           "data": {"crop_size": 32, "batch_size": 2, "num_workers": 0,
                    "train": {"type": "TwoStageDegradationImgMaskDataset",
                              "dataroot_gt": str(tmp_path / "gt"),
                              "dataroot_gt_mask": str(tmp_path / "mask")}},
           "train": {"max_steps": 1, "log_every": 1, "save_every": 0, "image_every": 0}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    before = ssg_cuda.launches
    state = dmain.main(["--train", "--base", str(tmp_path / "cfg.json"),
                        "--logdir", str(tmp_path / "logs")])
    assert ssg_cuda.launches == before + 1 and state.step == 1
    assert state.params["null_context"].is_cuda
    logged = capsys.readouterr().out
    assert "step 1 (" in logged and "nan" not in logged


@pytest.mark.cuda
def test_native_jpeg_matches_cv2_on_the_card_machine(card):
    """The BSRGAN degradation's C++ JPEG round trip, built by that machine's
    g++, against that machine's cv2 (libjpeg at its defaults), at sizes that
    are and are not multiples of 16: equal, or within one level on at most
    0.1% of the values."""
    try:
        import cv2
    except ImportError:
        pytest.skip("cv2 is not installed on this machine: nothing to hold the JPEG against")
    from ssl_tpu_torch.native import jpeg_libjpeg_roundtrip
    rng = np.random.RandomState(0)
    for (h, w), quality in (((64, 64), 75), ((61, 45), 85), ((256, 256), 95), ((37, 53), 90)):
        yy, xx = np.mgrid[0:h, 0:w]
        img = (128 + 60 * np.sin(yy / 5.0)[..., None] * np.cos(xx[..., None] / 7.0 + np.arange(3))
               + rng.randn(h, w, 3) * 20).clip(0, 255).astype(np.uint8)
        want = cv2.cvtColor(cv2.imdecode(cv2.imencode(
            ".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
            [int(cv2.IMWRITE_JPEG_QUALITY), quality])[1], 1), cv2.COLOR_BGR2RGB)
        d = np.abs(jpeg_libjpeg_roundtrip(img, quality).astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, ((h, w), quality, d.max())


@pytest.mark.cuda
def test_kair_step_on_card(card, tmp_path, monkeypatch):
    """Two iterations of a tiny KAIR file through the train CLI on the card
    (BSRGANRRDBNet nf 8, the BSRGAN degradation on the host with cv2 hidden,
    the stride-3 mask): K1 launched once per iteration, every loss finite,
    the nets on the card."""
    import json
    import sys

    from scipy.io import savemat

    import ssl_tpu_torch.train as ttrain
    from ssl_tpu_torch.utils.png import encode_png
    from torch_kair_cases import tiny_kair
    monkeypatch.setitem(sys.modules, "cv2", None)
    rng = np.random.RandomState(0)
    d = {k: str(tmp_path / k) for k in ("gt", "mask", "vgt", "vlq")}
    for k, path in d.items():
        (tmp_path / k).mkdir()
    for i in range(4):
        (tmp_path / "gt" / f"{i}.png").write_bytes(
            encode_png((rng.rand(64, 64, 3) * 255).astype(np.uint8)))
        savemat(str(tmp_path / "mask" / f"{i}.mat"),
                {"mat": (rng.rand(64, 64) < 0.2).astype(np.float64)})
    for name, size in (("vgt", 64), ("vlq", 16)):
        (tmp_path / name / "v.png").write_bytes(
            encode_png((rng.rand(size, size, 3) * 255).astype(np.uint8)))
    path = tmp_path / "kair.json"
    path.write_text(json.dumps(tiny_kair(d, "kair_card", iterations=2)))
    seen = []
    from ssl_tpu_torch.utils import logger as tlogger
    call = tlogger.MessageLogger.__call__
    monkeypatch.setattr(tlogger.MessageLogger, "__call__",
                        lambda self, logs: (seen.append(dict(logs)), call(self, logs))[1])
    before = ssg_cuda.launches
    state = ttrain.train_pipeline(str(tmp_path), ["-opt", str(path)])
    assert ssg_cuda.launches == before + 2 and state.step == 2
    assert next(state.net_g.parameters()).is_cuda and type(state.net_g).__name__ == "BSRGANRRDBNet"
    for logs in seen:
        for k in ("l_pix", "l_percep", "l_g_gan", "l_selfsim", "l_selfsim_kl", "l_d_real"):
            assert np.isfinite(logs[k]), (k, logs)


def _bf16_errors(got, ref, plain):
    """Relative L2 errors of the kernel's and the plain version's outputs
    against the float32 reference."""
    def rel(a, r):
        return float((a.float() - r).norm() / r.norm())
    return rel(got, ref), rel(plain, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_k2_bf16_forward_matches_float32_on_card(card, case):
    """The bf16 forward kernels fwd_plan names (the split and its combine,
    the d = 512 kernel) at the serving shapes, the packed-qkv strides
    included: o in bf16 within the BF16_FWD holds, lse against
    ``attention_lse_reference`` on the bf16 inputs, and bit for bit on repeat."""
    b, heads, n, m, d, scale, layout, logits = CUDA_CASES[case]
    q, k, v = attention_inputs(b, heads, n, m, d, scale, layout, logits, device="cuda",
                               dtype=torch.bfloat16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, _, plan = attention_cuda.fwd_plan(b, heads, n, m, d, sms, torch.bfloat16)
    before = dict(attention_cuda.fwd_kernel_launches)
    o, lse = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
    launched = {n_: c - before[n_] for n_, c in attention_cuda.fwd_kernel_launches.items()
                if c != before[n_]}
    assert launched == {n_: c for n_, c in plan.items() if c}
    o2, lse2 = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
    ref = sdp_attention_reference(q.float(), k.float(), v.float(), scale)
    plain = sdp_attention_reference(q, k, v, scale)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    err, plain_err = _bf16_errors(o, ref, plain)
    assert err <= BF16_FWD_REL_L2 and err <= BF16_PLAIN_RATIO * plain_err, (err, plain_err)
    ref_lse = attention_lse_reference(q, k, scale)
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 512])
@pytest.mark.parametrize("scale", [-0.125, 0.0])
def test_k2_bf16_forward_takes_any_scale_on_card(card, d, scale):
    """The bf16 forward at d = 64, 128 and 512 with a negative scale (there
    the row max of the scaled logits is the scale times the min) and a zero
    one (every probability equal): o within BF16_FWD_REL_L2 of float32, lse
    against ``attention_lse_reference``."""
    q, k, v = attention_inputs(1, 2, 512, 512, d, 0.125, "proj", 8.0, device="cuda",
                               dtype=torch.bfloat16)
    o, lse = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
    ref = sdp_attention_reference(q.float(), k.float(), v.float(), scale)
    torch.cuda.synchronize()
    err = float((o.float() - ref).norm() / ref.norm())
    assert err <= BF16_FWD_REL_L2, err
    ref_lse = attention_lse_reference(q, k, scale)
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(), rtol=1e-5, atol=1e-5)


def _check_bf16_backward(b, heads, n, m, d, scale, layout, logits):
    """The bf16 backward kernels bwd_plan names, fed the float32 reference's
    o and lse: the plan's launches, dq, dk and dv in bf16 within the BF16_BWD
    holds, and bit for bit on repeat."""
    q, k, v = attention_inputs(b, heads, n, m, d, scale, layout, logits, device="cuda",
                               dtype=torch.bfloat16)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    do = torch.randn((b, n, heads, d), generator=torch.Generator(device="cuda").manual_seed(11),
                     device="cuda").bfloat16()
    o = sdp_attention_reference(q32, k32, v32, scale)
    lse = attention_lse_reference(q32, k32, scale)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = attention_cuda.bwd_plan(b, heads, n, m, d, sms, torch.bfloat16)[3]
    before = dict(attention_cuda.bwd_kernel_launches)
    got = attention_cuda.flash_attn_bwd_cuda(q, k, v, o.bfloat16(), lse, do, scale)
    launched = {n_: c - before[n_] for n_, c in attention_cuda.bwd_kernel_launches.items()
                if c != before[n_]}
    assert launched == {n_: c for n_, c in plan.items() if c}
    again = attention_cuda.flash_attn_bwd_cuda(q, k, v, o.bfloat16(), lse, do, scale)
    ref = flash_attn_bwd_reference(q32, k32, v32, o, lse, do.float(), scale)
    plain = flash_attn_bwd_reference(q, k, v, o.bfloat16(), lse, do, scale)
    torch.cuda.synchronize()
    for name, g, g2, r, p in zip(("dq", "dk", "dv"), got, again, ref, plain):
        assert g.dtype == torch.bfloat16 and torch.equal(g, g2), name
        err, plain_err = _bf16_errors(g, r, p)
        assert err <= BF16_BWD_REL_L2 and err <= BF16_PLAIN_RATIO * plain_err, (name, err,
                                                                                plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_k2_bf16_backward_matches_float32_on_card(card, case):
    """The bf16 backward at the training shapes (``_check_bf16_backward``)."""
    _check_bf16_backward(*TRAIN_CASES[case])


@pytest.mark.cuda
def test_k2_bf16_d512_backward_odd_key_tiles_on_card(card):
    """The bf16 backward at d = 512 with an odd count of 128-key tiles, where
    p_ds runs unclustered (its own q and dO loads, no multicast), held as at
    the training shapes (``_check_bf16_backward``)."""
    assert attention_cuda.p_ds_cluster(384) == 1
    _check_bf16_backward(1, 1, 512, 384, 512, 512 ** -0.5, "proj", 8.0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["vae_mid", "odd_key_tiles"])
def test_k2_bf16_d512_products_match_float64_on_card(card, shape):
    """dkv_mm and dq_mm alone (``flash_attn_bwd_mm_cuda``) at vae_mid's
    training batch and at MM_ODD_CASE (odd tile counts), on the plain
    p_ds's bf16 scratch: one launch of each a call, dq, dk and dv in bf16
    within MM_REL_L2 of the float64 products of the same bf16 values and at
    most MM_LIBRARY_RATIO times the error of cuBLAS's bf16 products (float32
    sums, ``mm_library_calls``), and bit for bit on a second launch."""
    b, heads, n, m, d, scale, layout, logits = (TRAIN_CASES["vae_mid"] if shape == "vae_mid"
                                                else MM_ODD_CASE)
    q, k, v = attention_inputs(b, heads, n, m, d, scale, layout, logits, device="cuda",
                               dtype=torch.bfloat16)
    do = torch.randn((b, n, heads, d), generator=torch.Generator(device="cuda").manual_seed(11),
                     device="cuda").bfloat16()
    q32, k32 = q.float(), k.float()
    o = sdp_attention_reference(q32, k32, v.float(), scale).bfloat16()
    p_ds = flash_attn_bwd_p_ds_reference(q, k, v, o, attention_lse_reference(q32, k32, scale),
                                         do, scale)
    before = dict(attention_cuda.bwd_kernel_launches)
    got = attention_cuda.flash_attn_bwd_mm_cuda(p_ds, q, k, do, scale)
    launched = {n_: c - before[n_] for n_, c in attention_cuda.bwd_kernel_launches.items()
                if c != before[n_]}
    assert launched == dict.fromkeys(attention_cuda.MM_KERNELS_BF16, 1)
    again = attention_cuda.flash_attn_bwd_mm_cuda(p_ds, q, k, do, scale)
    exact = flash_attn_bwd_mm_reference(p_ds.double(), q.double(), k.double(), do.double(), scale)
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        library = {name: call() for name, call in mm_library_calls(p_ds, q, k, do, scale).items()}
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    torch.cuda.synchronize()
    for name, g, g2, e in zip(("dq", "dk", "dv"), got, again, exact):
        assert g.dtype == torch.bfloat16 and torch.equal(g, g2), name
        err = float((g.double() - e).norm() / e.norm())
        lib_err = float((library[name].double() - e).norm() / e.norm())
        assert err <= MM_REL_L2 and err <= MM_LIBRARY_RATIO * lib_err, (name, err, lib_err)


@pytest.mark.cuda
def test_k2_bf16_autograd_goes_through_the_bf16_kernels(card):
    """A gradient through an eligible bf16 call: one bf16 forward launch with
    lse and one bf16 backward call, gradients in bf16, no float32 kernel."""
    q, k, v = attention_inputs(1, 2, 512, 512, 64, 0.125, "qkv", 8.0, device="cuda",
                               dtype=torch.bfloat16)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    fwd, bwd = dict(attention_cuda.fwd_kernel_launches), dict(attention_cuda.bwd_kernel_launches)
    out = sdp_attention(*leaves, 0.125, use_flash=True)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and all(t.grad.dtype == torch.bfloat16 for t in leaves)
    moved = [n_ for counts, was in ((attention_cuda.fwd_kernel_launches, fwd),
                                    (attention_cuda.bwd_kernel_launches, bwd))
             for n_, c in counts.items() if c != was[n_]]
    assert moved and all(n_.endswith("_bf16") for n_ in moved), moved


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["serve", "train"])
def test_k2_bf16_d512_repeats_bit_for_bit(card, path):
    """vae_mid in bf16 at b = 1 (serving: the split key loop and its combine)
    and b = 2 (training): the forward's o and lse and the backward's dq, dk
    and dv (p_ds's P and dS through scratch) repeat bit for bit: no atomics,
    the clusters' shared tiles summed in a fixed order."""
    b, heads, n, m, d, scale, layout, logits = (CUDA_CASES if path == "serve"
                                                else TRAIN_CASES)["vae_mid"]
    q, k, v = attention_inputs(b, heads, n, m, d, scale, layout, logits, device="cuda",
                               dtype=torch.bfloat16)
    do = torch.randn((b, n, heads, d), generator=torch.Generator(device="cuda").manual_seed(11),
                     device="cuda").bfloat16()
    first = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
    second = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
    grads = [attention_cuda.flash_attn_bwd_cuda(q, k, v, *first, do, scale) for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b_ in zip(("o", "lse", "dq", "dk", "dv"), (*first, *grads[0]),
                           (*second, *grads[1])):
        assert torch.equal(a, b_), name


@pytest.mark.cuda
def test_k2_bf16_d512_raises_instead_of_falling_back(card):
    """The d = 512 bf16 kernels take what the plan takes or raise: a sequence
    that is no multiple of 128, mixed types or a gradient of another type
    never reach the plain version, and no kernel is counted."""
    q, k, v = attention_inputs(1, 1, 512, 512, 512, 512 ** -0.5, "proj", 8.0, device="cuda",
                               dtype=torch.bfloat16)
    fwd, bwd = dict(attention_cuda.fwd_kernel_launches), dict(attention_cuda.bwd_kernel_launches)
    with pytest.raises(ValueError, match="multiples of 128"):
        attention_cuda.flash_attn_fwd_cuda(q[:, :192], k, v, 512 ** -0.5)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        attention_cuda.flash_attn_fwd_cuda(q, k.float(), v, 512 ** -0.5)
    o, lse = attention_cuda.flash_attn_fwd_cuda(q, k, v, 512 ** -0.5, return_lse=True)
    do32 = torch.zeros_like(o, dtype=torch.float32)
    with pytest.raises(TypeError, match="do must be"):
        attention_cuda.flash_attn_bwd_cuda(q, k, v, o, lse, do32, 512 ** -0.5)
    with pytest.raises(ValueError, match="multiples of 128"):
        attention_cuda.flash_attn_bwd_cuda(q, k[:, :320], v[:, :320], o, lse, o, 512 ** -0.5)
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = attention_cuda.fwd_plan(1, 1, 512, 512, 512, sms, torch.bfloat16)[2]
    assert {n_: c - fwd[n_] for n_, c in attention_cuda.fwd_kernel_launches.items()
            if c != fwd[n_]} == {n_: c for n_, c in plan.items() if c}   # the one good call
    assert attention_cuda.bwd_kernel_launches == bwd
