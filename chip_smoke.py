"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; the first failure exits non-zero:

1. build   compile the port's CUDA kernels (K1 ssg_loss_fwd, K2
           flash_attn_fwd and flash_attn_bwd) with nvcc, one process per
           source, all at once
2. kernel  hold K1 (ssl_tpu_torch/csrc/ssg_loss_fwd.cu) against its plain
           PyTorch version on the card: a small case (search 9, window 5),
           the shipped search 25 / window 9 / sigma 0.004 on smooth images
           at 32^2, at the ESRGAN step's shape (b16, 3x128^2) and at the
           diffusion mini-step's (b2, 3x512^2), and the ESRGAN step's own
           inputs (bench.py's uniform images, on which every off-centre q is
           0); forward outputs and d_sr through the autograd function, with
           the L1 subgradient's ties accounted for, and a second launch bit
           for bit; times the kernel (CUDA events and the profiler), the
           plain forward and the backward.  Then hold K2's forward
           (ssl_tpu_torch/csrc/flash_attn_fwd.cu: flash_attn_fwd, at d = 512
           flash_attn_fwd_d512, and flash_attn_fwd_combine where the key
           loop is split) against its plain version at each shape the
           serving path gives it and at one case with logits up to 50, and a
           second launch bit for bit; times each kernel (profiler), the
           wrapper, the plain version and torch's
           scaled_dot_product_attention (the yardstick, which the port never
           calls).  Then K2's backward
           (ssl_tpu_torch/csrc/flash_attn_bwd.cu: dkv and dq, the ordered sum
           of split parts, and at d = 512 p_ds, dkv_mm and dq_mm) and the
           forward's lse at each shape of the training path: against
           flash_attn_bwd_reference and autograd through the plain
           attention, and a second launch bit for bit against the first;
           times the kernels (each alone from the profiler), the plain
           backward and SDPA's backward.  TF32 is off throughout for the
           plain versions; the kernels' own products are 3xTF32.
3. diffusion  the StableSR-SSL model of options/diffusion/ssl_base.yml at
           full width with model.use_flash_attention on, random weights from
           seeds; every layer the init leaves at 0 is drawn from a seeded
           normal, so that the attention reaches the UNet's output
4. e2e     one 256^2 request (5 spaced-DDPM steps, TF32 off) through the K2
           route and through the plain route on the same generator seeds;
           the decoded images must agree to E2E_REL_L2 (relative L2)
5. serve   2 requests, each a 128^2 smooth LQ image upsampled to 512^2:
           VAE encode -> 50 spaced-DDPM steps -> decode -> AdaIN color fix,
           through the inference CLI's own ``restore``; times per request,
           per denoising step, VAE encode and decode, peak memory, and the
           K2 launch count, which must be 14 per step and 2 per request,
           with every forward kernel launched
6. train_e2e  one training mini-step at 256^2, batch 2, TF32 off, through
           the K2 route and the plain route from the same weights and draws:
           the logs within TRAIN_LOG_RTOL and every parameter's gradient
           within TRAIN_GRAD_REL_L2; K2 launches as derived
7. diffusion_train  the shipped training options (lr 5e-5, 12 mini-steps
           per update, EMA 0.9999) at 512^2, batch 2, on smooth synthetic
           GT/LQ with a mask of density 0.25: one full accumulation cycle of
           12 mini-steps through train_step; logs finite, weights unchanged
           after mini-steps 1-11 and moved after 12, the EMA moved, K1 once
           and K2 17 forward and 15 backward per mini-step, every K2
           kernel launched; times, peak memory and K2's forward and
           backward device time per mini-step
8. train   the ESRGAN-SSL train step at the shipped widths (RRDBNet 64/23/32,
           VGGStyleDiscriminator 64, VGG19 conv5_4, SSL 25/9/0.004), batch 16,
           gt 128: one warm-up step and 3 timed steps through build_model ->
           init_state -> train_step, with the K1 launch count read around
           them
9. kernels one line per ported kernel: launches on its main paths, error
           against the plain version, times and the bound

then the card's name and power limit as nvidia-smi reports them, and last
{"ok": true, "device": {...}}.  Weights are random from fixed seeds (no
VGG19, UNet or VAE weight file is in the repository).  Needs one CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): the bound of a kernel is
# the larger of its bytes over the memory rate and its operations over the
# rate of the units that do them: K1's fp32 window sums on the CUDA cores;
# K2's matrix products as 3xTF32 on the tensor cores (three TF32 products
# each, as the backward kernels and torch's fp32 SDPA compute them), its
# softmax's elementwise work on the CUDA cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12

MAIN_B, MAIN_GT, SCALE = 16, 128, 4

# The TPU kernels K2's backward replaces: upstream's Pallas TPU flash attention
# (jax/experimental/pallas/ops/tpu/flash_attention.py, jax 0.9.0), whose custom
# VJP ssl_tpu/ops/attention.py:32-39 reaches.
UPSTREAM_DKV = ("jax/experimental/pallas/ops/tpu/flash_attention.py:941 "
                "_flash_attention_bwd_dkv (via ssl_tpu/ops/attention.py:32)")
UPSTREAM_DQ = ("jax/experimental/pallas/ops/tpu/flash_attention.py:1287 "
               "_flash_attention_bwd_dq (via ssl_tpu/ops/attention.py:32)")

# |x - y| / max(x, y) below which the plain forward's sign(x - y) counts as
# tied: q carries up to ~1e-5 of relative rounding at sigma 0.004 and the
# kernel's inverse maps ~2e-5, so another summation order moves x - y by less.
TIE_RTOL = 1e-4
# Largest relative L2 error of d_sr with the full mask, where tied signs that
# flip move g_d by 2 g_l1 at their pixel-offsets (2.05e-5 on an H100 at b16,
# 3x128^2, search 25, window 9, sigma 0.004 on smooth images: PERF.md).
D_SR_REL_L2 = 1e-3

# The serving path: ssl_base.yml at 512^2 (a 64^2 latent), spaced DDPM.
SERVE_LQ, SERVE_SIZE, SERVE_STEPS, SERVE_REQUESTS = 128, 512, 50, 2
# K2 launches there: per denoising step the UNet's self-attention at ds 1
# and ds 2 (5 each) and the struct-cond encoder's at ds 1 and ds 2 (2 each);
# per request the VAE encoder's and decoder's mid-blocks.  At ds 4 (256
# tokens) and in the cross-attention (77) the plain path runs, as in JAX.
K2_PER_STEP, K2_PER_REQUEST = 14, 2
# K2 launches of one serving request by case of tests/torch_attention_cases.py
SERVE_MIX = {"unet_ds1": 5 * SERVE_STEPS, "struct_ds1": 2 * SERVE_STEPS,
             "unet_ds2": 5 * SERVE_STEPS, "struct_ds2": 2 * SERVE_STEPS, "vae_mid": 2}
# The K2-vs-plain hold end to end: a 256^2 request (a 32^2 latent: 7 K2
# launches per step, 2 per request), 5 steps, TF32 off.  Largest relative
# L2 error of the decoded image between the two routes (PERF.md states it
# before the first run).
E2E_LQ, E2E_STEPS, E2E_K2_LAUNCHES = 64, 5, 5 * 7 + 2
E2E_REL_L2 = 1e-3
# K2's backward against its plain version (flash_attn_bwd_reference and
# autograd through the plain attention): each of dq, dk and dv within this
# relative L2, and elementwise within rtol 1e-3 and an atol of 1e-4 of the
# largest value.  dS = P * (dP - di) subtracts nearly equal numbers where a
# logit barely matters, and the two sides form di in other orders, so single
# elements carry the cancellation's error on the gradient's own scale.
BWD_REL_L2, BWD_RTOL, BWD_ATOL = 1e-4, 1e-3, 1e-4
# The training path: ssl_base.yml at 512^2 (64^2 latent), batch 2.  K2 per
# mini-step: forward with lse in the UNet (10) and the struct-cond encoder
# (4), the no-grad VAE encoder over [gt; lq] (1), the decoder's mid
# attention (1) and its replay under remat (1); backward in all but the
# encoder and the replay.  tests/test_torch_diffusion_config.py counts them
# on the meta device.
TRAIN_B, TRAIN_SIZE, TRAIN_MINI_STEPS = 2, 512, 12
TRAIN_K2_FWD, TRAIN_K2_BWD = 17, 15
# The K2-vs-plain hold of one mini-step at 256^2 (a 32^2 latent: the
# UNet's and struct-cond encoder's ds-1 attentions and the VAE's mid
# attention are eligible; 5 + 2 with lse, the encoder 1, the decoder 1 and
# its replay 1), TF32 off.  Bounds stated before the first run (PERF.md).
TRAIN_E2E_SIZE, TRAIN_E2E_K2 = 256, {"fwd": 10, "bwd": 8}
TRAIN_LOG_RTOL, TRAIN_GRAD_REL_L2 = 1e-4, 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def shipped_opt(batch: int) -> dict:
    """options/train/ESRGANSSL/train_ESRGANSSL_bicubic_x4.yml as a dict (the
    card's machine has no yaml), with the batch of this run."""
    return {
        "name": "ESRGANSSL_bicubic_x4", "model_type": "ESRGANSSLModel", "scale": SCALE,
        "num_devices": 1, "manual_seed": 0,
        "datasets": {"train": {"gt_size": MAIN_GT, "batch_size_per_gpu": batch}},
        "network_g": {"type": "RRDBNet", "num_in_ch": 3, "num_out_ch": 3, "num_feat": 64,
                      "num_block": 23, "num_grow_ch": 32},
        "network_d": {"type": "VGGStyleDiscriminator", "num_in_ch": 3, "num_feat": 64,
                      "input_size": 128},
        "path": {"pretrain_network_g": None, "param_key_g": "params", "strict_load_g": True},
        "ssl_setting": {"mask_stride": 3, "impl": "dense", "kernel_size_search": 25,
                        "sigma": 0.004, "kernel_size_window": 9, "generalization": True},
        "train": {
            "ema_decay": 0.999,
            "optim_g": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "optim_d": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [50000, 100000, 200000, 300000],
                          "gamma": 0.5},
            "total_iter": 400000, "warmup_iter": -1,
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1e-2, "reduction": "mean"},
            "selfsim_opt": {"type": "L1Loss", "loss_weight": 1e3, "reduction": "mean"},
            "selfsim1_opt": {"type": "KLDistanceLoss", "loss_weight": 1e3, "reduction": "mean",
                             "softmax": False},
            "perceptual_opt": {"type": "PerceptualLoss", "layer_weights": {"conv5_4": 1},
                               "vgg_type": "vgg19", "use_input_norm": True, "range_norm": False,
                               "perceptual_weight": 1.0, "style_weight": 0, "criterion": "l1"},
            "gan_opt": {"type": "GANLoss", "gan_type": "vanilla", "real_label_val": 1.0,
                        "fake_label_val": 0.0, "loss_weight": 5e-3},
            "net_d_iters": 1, "net_d_init_iters": 0,
        },
    }


def smooth_case(b, h, seed, density):
    """Smooth images with a noisy copy: the regime where q is far from 0.
    Values stay within about [-0.1, 1.25], the range of the SR data; image
    i is the pattern moved by 0.1 (i // 3) and scaled by 0.9 + 0.1 (i % 3),
    so the first two are those of tests/torch_ssg_cases.py."""
    import numpy as np
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:h] / h

    def base(shift):
        x = xx + shift
        return np.stack([np.sin(6 * yy) + np.cos(5 * x), yy * x, np.cos(8 * (yy + x))]) * 0.3 + 0.5

    gt = np.stack([base(0.1 * (i // 3)) * (0.9 + 0.1 * (i % 3)) for i in range(b)])
    gt = gt.astype(np.float32)
    sr = (gt + rng.randn(b, 3, h, h) * 0.1).astype(np.float32)
    mask = (rng.rand(b, h, h) < density).astype(np.float32)
    return sr, gt, mask


def bench_case(b, h, seed, density):
    """bench.py:122-126's inputs: uniform images and a mask of the given density."""
    import numpy as np
    rng = np.random.RandomState(seed)
    gt = rng.rand(b, 3, h, h).astype(np.float32)
    sr = rng.rand(b, 3, h, h).astype(np.float32)
    mask = (rng.rand(b, h, h) < density).astype(np.float32)
    return sr, gt, mask


def k1_operations(b, c, h, w, search, generalization=True) -> float:
    """fp32 operations K1's function needs, counting each exp/log as one:
    per image, pixel and offset the windowed SSD with O(1) running box-sums
    (3c for the squared differences, 1 for -C2, 4 for the two box-sums, 1 for
    +box9(C2)) and the epilogue (2 scalings, 1 exp) = 3c + 9; each sweep adds
    one accumulate; sweep 2 adds 16 for the loss terms and a/b maps."""
    per_q = 3 * c + 9
    sweeps = 2 if generalization else 1
    return float(b * h * w * search * search * (sweeps * 2 * (per_q + 1) + 16))


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def check_close(name, got, ref, rtol, atol=0.0):
    import torch
    got, ref = got.detach().double(), ref.detach().double()
    bad = (got - ref).abs() > atol + rtol * ref.abs()
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        fail(f"{name}: {int(bad.sum())} elements off (rtol {rtol}, atol {atol}); first at "
             f"{i}: {float(got.flatten()[i])} vs {float(ref.flatten()[i])}")
    return float((got - ref).abs().max()) if got.numel() else 0.0


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_build():
    """Compile every kernel of the port, one nvcc process per source, all at once."""
    from concurrent.futures import ThreadPoolExecutor
    from ssl_tpu_torch.ops import cuda_build
    names = ("ssg_loss_fwd", "flash_attn_fwd", "flash_attn_bwd")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        logs = dict(zip(names, pool.map(lambda n: cuda_build.build(n)[1], names)))
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels": list(names),
          "ptxas": {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
                    for n, log in logs.items()}})


def near_ties(sr, gt, ref, cfg):
    """The plain forward's pixel-offsets at which sign(x - y), or [x > 1e-10],
    lies within rounding of the other side: |x - y| <= TIE_RTOL max(x, y), or
    x within TIE_RTOL of 1e-10.  Another summation order (the kernel's) may
    take either side there, which moves a_map by up to 2x and d_sr through
    the backward's g_d.  ``ref`` is the plain forward's output.  Returns the
    (b, h, w) pixels with any such offset, the number of tied pixel-offsets,
    a_map's lower and upper bounds with every tied sign free in [-1, 1], and
    sum_d x."""
    import torch
    from ssl_tpu_torch.ops.ssg import _context, _q_maps
    b, c = sr.shape[:2]
    inv_sr, inv_gt = ref[3], ref[4]
    ctx = _context(torch.cat([sr, gt]), cfg)
    norm = c * float(cfg.window) ** 2
    tied_px = torch.zeros(inv_sr.shape, dtype=torch.bool, device=sr.device)
    n_tied = torch.zeros((), device=sr.device)
    a_fixed, a_free, x_sum = (torch.zeros_like(inv_sr) for _ in range(3))
    for s in range(cfg.search ** 2):
        q_sr, q_gt = _q_maps(ctx, s, cfg, norm, b)
        x, y = q_sr * inv_sr, q_gt * inv_gt
        top = torch.maximum(x, y)
        tie = ((x - y).abs() <= TIE_RTOL * top) & (top > 0)
        tied_px |= tie | ((x - 1e-10).abs() <= TIE_RTOL * 1e-10)
        n_tied += tie.sum()
        a_fixed += torch.sign(x - y) * x * ~tie
        a_free += x * tie
        x_sum += x
    return tied_px, int(n_tied), a_fixed - a_free, a_fixed + a_free, x_sum


def hold_k1(name, sr, gt, mask, cfg, map_rtol, fwd):
    """Hold the forward ``fwd`` (K1's wrapper) and d_sr through the autograd
    function against the plain version; fail() at the first disagreement.

    Tolerances: count exact; l1 rel 1e-4 and kl rel 1e-3 (the contract of
    tests/test_ssg_pallas.py:30-31, sums taken in another order); inv_sr,
    inv_gt and b_map ``map_rtol`` (1e-5; 1e-4 at sigma 0.004 on smooth images,
    where S_d = box9(C2) + rect(D - C2) cancels a box of ~70 and q carries
    ~1e-5 of relative rounding: tests/torch_ssg_cases.py) with an atol of 1e-6
    of the map's largest value (elements that small are sums of cancelling
    terms).  a_map = sum_d sign(x - y) x: inside the plain version's bounds
    with the tied signs free (``near_ties``), widened by map_rtol sum_d x, the
    rounding of the x it sums.  d_sr: with the tied pixels taken out of the
    mask, rtol 1e-4 (tests/test_ssg_pallas.py:48) with an atol of 1e-7 or 1e-6
    of the gradient's largest value, whichever is larger (the backward's terms
    inv g_d - inv^2 T cancel, so d_sr carries the maps' rounding on its own
    scale); with the full mask, a relative L2 error of at most D_SR_REL_L2.

    Returns the largest absolute differences and what the ties did."""
    import torch
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.ops.ssg import ssl_loss_dense_bwd, ssl_loss_sums_reference

    got = fwd(sr, gt, mask, cfg)
    ref = ssl_loss_sums_reference(sr, gt, mask, cfg)
    if float(got[2]) != float(ref[2]):
        fail(f"{name}: count {float(got[2])} vs {float(ref[2])}")
    errs = {"l1": check_close(f"{name} l1", got[0], ref[0], 1e-4),
            "kl": check_close(f"{name} kl", got[1], ref[1], 1e-3), "count": 0.0}
    for i, key in ((3, "inv_sr"), (4, "inv_gt"), (6, "b_map")):
        errs[key] = check_close(f"{name} {key}", got[i], ref[i], map_rtol,
                                1e-6 * float(ref[i].abs().max()))

    tied, n_tied, a_lo, a_hi, x_sum = near_ties(sr, gt, ref, cfg)
    slack = map_rtol * x_sum
    outside = (got[5] < a_lo - slack) | (got[5] > a_hi + slack)
    if bool(outside.any()):
        i = int(outside.flatten().nonzero()[0])
        fail(f"{name} a_map: {int(outside.sum())} elements outside the plain version's bounds "
             f"with tied signs free; first at {i}: {float(got[5].flatten()[i])} not in "
             f"[{float(a_lo.flatten()[i])}, {float(a_hi.flatten()[i])}]")
    a_diff = (got[5] - ref[5]).abs()
    a_off = a_diff > map_rtol * ref[5].abs() + 1e-6 * float(ref[5].abs().max())
    errs["a_map"] = float(a_diff.max())

    one = torch.ones((), device=sr.device)

    def d_sr(m):
        """(autograd through fwd, the backward fed the plain maps) for mask m."""
        s = sr.clone().requires_grad_(True)
        l1, kl, _ = ssg_cuda.ssl_loss_sums(s, gt, m, cfg)
        (l1 + kl).backward()
        return s.grad, ssl_loss_dense_bwd(sr, gt, m, ref[3], ref[4], one, one, cfg,
                                          ref[5], ref[6])

    got_d, ref_d = d_sr(mask * ~tied)
    check_close(f"{name} d_sr with the tied pixels out of the mask", got_d, ref_d, 1e-4,
                max(1e-7, 1e-6 * float(ref_d.abs().max())))
    got_d, ref_d = d_sr(mask)
    d_diff = got_d - ref_d
    rel_l2 = float(d_diff.norm() / ref_d.norm().clamp_min(1e-30))
    if rel_l2 > D_SR_REL_L2:
        fail(f"{name} d_sr: relative L2 error {rel_l2} above {D_SR_REL_L2}")
    d_off = d_diff.abs() > 1e-4 * ref_d.abs() + max(1e-7, 1e-6 * float(ref_d.abs().max()))
    errs["d_sr"] = float(d_diff.abs().max())
    ties = {"tied_pixel_offsets": n_tied,
            "tied_share": n_tied / (mask.numel() * cfg.search ** 2),
            "pixels_with_a_tie": int(tied.sum()),
            "masked_pixels_with_a_tie": int((tied & (mask > 0)).sum()),
            "a_map_off_elementwise": int(a_off.sum()),
            "a_map_off_at_untied_pixels": int((a_off & ~tied).sum()),
            "a_map_max_abs_at_tied_pixels": float((a_diff * tied).max()),
            "a_map_max_abs_at_untied_pixels": float((a_diff * ~tied).max()),
            "a_map_max_abs_over_sum_x_at_untied_pixels": float((a_diff * ~tied / x_sum).max()),
            "d_sr_rel_l2": rel_l2, "d_sr_off_elementwise_share": float(d_off.float().mean()),
            "d_sr_max_abs": float(ref_d.abs().max())}
    return errs, ties


def phase_kernel():
    """K1 against its plain version (``hold_k1``) and a second launch bit for
    bit against the first, then its times (CUDA events, and the kernel alone
    from the profiler).  Returns the results by case: ``main_path`` and
    ``diffusion_smooth`` are the shapes the ESRGAN step and the diffusion
    mini-step give it."""
    import torch
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.ops.ssg import SSGConfig, ssl_loss_dense_bwd, ssl_loss_sums_reference

    shipped = SSGConfig(search=25, window=9, sigma=0.004)
    cases = [("small", smooth_case(2, 20, 47, 0.3), SSGConfig(search=9, window=5, sigma=0.1),
              1e-5),
             ("shipped_32", smooth_case(1, 32, 2, 0.3), shipped, 1e-4),
             ("main_smooth", smooth_case(MAIN_B, MAIN_GT, 3, 0.25), shipped, 1e-4),
             ("main_path", bench_case(MAIN_B, MAIN_GT, 0, 0.25), shipped, 1e-5),
             ("diffusion_smooth", smooth_case(TRAIN_B, TRAIN_SIZE, 4, 0.25), shipped, 1e-4)]
    results = {}
    for name, arrays, cfg, map_rtol in cases:
        sr, gt, mask = (torch.from_numpy(a).cuda() for a in arrays)
        errs, ties = hold_k1(name, sr, gt, mask, cfg, map_rtol, ssg_cuda.ssg_loss_fwd_cuda)
        first, again = (ssg_cuda.ssg_loss_fwd_cuda(sr, gt, mask, cfg) for _ in range(2))
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            fail(f"K1 {name}: a second launch differs from the first")
        del first, again
        one = torch.ones((), device="cuda")
        iters = 20 if sr.shape[0] == MAIN_B or sr.shape[-1] == TRAIN_SIZE else 50
        kernel_ms = time_ms(lambda: ssg_cuda.ssg_loss_fwd_cuda(sr, gt, mask, cfg), iters)
        device_ms = sum(kernel_device_ms(lambda: ssg_cuda.ssg_loss_fwd_cuda(sr, gt, mask, cfg),
                                         "ssg_loss_fwd", 5).values())
        plain_ms = time_ms(lambda: ssl_loss_sums_reference(sr, gt, mask, cfg), 2)
        maps = ssg_cuda.ssg_loss_fwd_cuda(sr, gt, mask, cfg)
        bwd_ms = time_ms(lambda: ssl_loss_dense_bwd(sr, gt, mask, maps[3], maps[4], one, one,
                                                    cfg, maps[5], maps[6]), 2)
        b, c, h, w = sr.shape
        nbytes = 4 * (2 * b * c * h * w + b * h * w) + 4 * (4 * b * h * w + 3)
        ops = k1_operations(b, c, h, w, cfg.search, cfg.generalization)
        bound_ms = 1e3 * max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S)
        results[name] = {"max_abs_err": max(errs.values()), "ms": kernel_ms,
                         "device_ms": device_ms, "plain_ms": plain_ms, "bwd_ms": bwd_ms,
                         "bound_ms": bound_ms,
                         "bound_by": "bytes" if nbytes / PEAK_BYTES_PER_S
                         > ops / PEAK_FP32_PER_S else "operations"}
        emit({"phase": "kernel", "kernel": "ssg_loss_fwd", "case": name,
              "shape": [b, c, h, w], "search": cfg.search, "window": cfg.window,
              "sigma": cfg.sigma, "max_abs_err": errs, "ties": ties, "repeat_bit_for_bit": True,
              "kernel_ms": kernel_ms, "device_ms": device_ms, "plain_ms": plain_ms,
              "bwd_ms": bwd_ms, "bytes": nbytes, "operations": ops, "bound_ms": bound_ms,
              "fraction_of_bound": bound_ms / device_ms, "launches_so_far": ssg_cuda.launches})
        del sr, gt, mask
        torch.cuda.empty_cache()
    return results


def k2_bound(products: float, elementwise: float, nbytes: float) -> dict:
    """K2's least times (ms): ``ops_ms`` with the matrix products as 3xTF32
    at the tensor cores' TF32 rate and the elementwise operations at the
    fp32 rate; ``bytes_ms`` for the bytes; ``fp32_ops_ms`` with everything on
    the CUDA cores (the bound PRs 1-3 reported)."""
    return {"ops_ms": 1e3 * (3 * products / PEAK_TF32_PER_S + elementwise / PEAK_FP32_PER_S),
            "bytes_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
            "fp32_ops_ms": 1e3 * (products + elementwise) / PEAK_FP32_PER_S}


def k2_times(b, h, n, m, d):
    """K2's forward: 4bhnmd for the two products, 5bhnm for scale, max, exp,
    sum and the normalisation; q, k, v read once, o written once."""
    return k2_bound(4 * b * h * n * m * d, 5 * b * h * n * m, 4 * b * h * (2 * n * d + 2 * m * d))


def k2_combine_times(b, h, n, d, split):
    """The least time of flash_attn_fwd_combine: it reads each part's output
    and row max and sum once and writes o and lse once (bytes); per output
    element and part one exp-weighted FMA, per row and part an exp."""
    rows = b * h * n
    nbytes = 4 * (split * rows * (d + 2) + rows * (d + 1))
    return k2_bound(0, 2 * split * rows * d + 3 * split * rows, nbytes)


def phase_k2():
    """K2's forward against its plain version at the serving path's shapes and
    at large logits, and a second launch bit for bit against the first; then
    the kernels' device times (each alone from the profiler, checked against
    ``fwd_plan``), the wrapper's, the plain version's and torch SDPA's times
    (CUDA events).  Where the plan splits the key loop, the combine's plain
    time (``combine_parts`` on parts of the same shapes).  Tolerance: rtol
    1e-4 with an atol of 1e-5 of the output's largest value (both sum in
    float32, in another order)."""
    import torch
    import torch.nn.functional as F
    from torch_attention_cases import CUDA_CASES, attention_inputs, combine_parts
    from ssl_tpu_torch.ops import attention_cuda
    from ssl_tpu_torch.ops.attention import sdp_attention_reference

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for name, (b, h, n, m, d, scale, layout, logit_range) in CUDA_CASES.items():
        q, k, v = attention_inputs(b, h, n, m, d, scale, layout, logit_range, device="cuda")
        split, _, plan = attention_cuda.fwd_plan(b, h, n, m, d, sms)
        before = dict(attention_cuda.fwd_kernel_launches)
        got = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale)
        launched = {k_: c - before[k_] for k_, c in attention_cuda.fwd_kernel_launches.items()}
        if launched != {k_: plan.get(k_, 0) for k_ in launched}:
            fail(f"K2 {name}: kernels launched {launched}, the plan {plan}")
        again = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale)
        ref = sdp_attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"K2 {name}: a second launch differs from the first by up to "
                 f"{float((got - again).abs().max())}")
        atol = 1e-5 * float(ref.abs().max())
        err = check_close(f"K2 {name}", got, ref, 1e-4, atol)
        del again
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, scale=scale)

        def kernel():
            return attention_cuda.flash_attn_fwd_cuda(q, k, v, scale)

        library_err = float((library().transpose(1, 2) - ref).abs().max())
        device = {k_.removesuffix("_kernel"): v_
                  for k_, v_ in kernel_device_ms(kernel, "flash_attn_fwd", 10).items()}
        if set(device) != {k_ for k_, c in plan.items() if c}:
            fail(f"K2 {name}: the profiler shows kernels {sorted(device)}, the plan {plan}")
        kernel_ms = time_ms(kernel, 20)
        plain_ms = time_ms(lambda: sdp_attention_reference(q, k, v, scale), 20)
        library_ms = time_ms(library, 20)
        bound = k2_times(b, h, n, m, d)
        bound_ms = max(bound["ops_ms"], bound["bytes_ms"])
        bound_by = "operations" if bound["ops_ms"] >= bound["bytes_ms"] else "bytes"
        combine = {}
        if split > 1:
            parts = [(torch.randn((b, n, h, d), device="cuda"),
                      torch.randn((b, h, n), device="cuda"), torch.rand((b, h, n), device="cuda"))
                     for _ in range(split)]
            combine = {"combine_plain_ms": time_ms(lambda: combine_parts(parts), 20),
                       "combine_bounds": k2_combine_times(b, h, n, d, split)}
            del parts
        results[name] = {"max_abs_err": err, "ms": kernel_ms, "device_ms": device,
                         "plain_ms": plain_ms, "library_ms": library_ms, "split": split,
                         "launches": {k_: c for k_, c in plan.items() if c}, **bound, **combine}
        emit({"phase": "kernel", "kernel": "flash_attn_fwd", "case": name,
              "b_heads_n_m_d": [b, h, n, m, d], "layout": layout, "sm_scale": scale,
              "logit_range": logit_range, "split": split, "max_abs_err": err, "atol": atol,
              "repeat_bit_for_bit": True, "library_max_abs_err": library_err,
              "kernel_ms": kernel_ms, "kernels_device_ms": device,
              "device_ms": sum(device.values()), "plain_ms": plain_ms, "library_ms": library_ms,
              **combine, "bound_ms": bound_ms, "bound_by": bound_by,
              "fraction_of_bound": bound_ms / sum(device.values()),
              "fraction_of_fp32_bound": bound["fp32_ops_ms"] / sum(device.values())})
        del q, k, v, got, ref
        torch.cuda.empty_cache()
    return results


def k2_bwd_times(b, h, n, m, d, splits=(1, 1)):
    """The least times of K2's backward kernels (``k2_bound`` each).  Per
    kernel: the fused dkv needs q kᵀ, dO vᵀ, Pᵀ dO and dSᵀ q (8bhnmd) and
    5bhnm for P and dS; the fused dq q kᵀ, dO vᵀ and dS k (6bhnmd) and the
    same 5bhnm; at d = 512 p_ds needs the two logit products (4bhnmd) and
    5bhnm and writes P and dS, dkv_mm Pᵀ dO and dSᵀ q (4bhnmd) and dq_mm dS k
    (2bhnmd), reading P and dS; sum adds the split parts (``splits`` =
    dkv's, dq's).  "bwd" is the function: 10bhnmd + 8bhnm, q, k, v, dO, lse
    and di read once and dq, dk, dv written once."""
    nm, nd, md = b * h * n * m, b * h * n * d, b * h * m * d
    inputs = 4 * (2 * nd + 2 * md + 2 * b * h * n)
    parts = 2 * md * splits[0] * (splits[0] > 1) + nd * splits[1] * (splits[1] > 1)
    outs = 2 * md * (splits[0] > 1) + nd * (splits[1] > 1)
    work = {"dkv": (8 * nm * d, 5 * nm, inputs + 4 * 2 * md),
            "dq": (6 * nm * d, 5 * nm, inputs + 4 * nd),
            "p_ds": (4 * nm * d, 5 * nm, inputs + 4 * 2 * nm),
            "dkv_mm": (4 * nm * d, 0, 4 * (2 * nm + 2 * nd + 2 * md)),
            "dq_mm": (2 * nm * d, 0, 4 * (nm + md + nd)),
            "sum": (0, parts - outs, 4 * (parts + outs)),
            "bwd": (10 * nm * d, 8 * nm, inputs + 4 * (nd + 2 * md))}
    return {k: k2_bound(*w) for k, w in work.items()}


def kernel_device_ms(fn, prefix: str, iters: int = 5) -> dict:
    """Device time (ms per call of ``fn``) of each kernel whose name contains
    ``prefix``, by its short name, from torch.profiler over ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        short = re.search(re.escape(prefix) + r"\w*", e.key)
        if e.device_type.name == "CUDA" and short:
            out[short[0]] = out.get(short[0], 0.0) + e.self_device_time_total / 1e3 / iters
    if not out or not all(v > 0 for v in out.values()):
        fail(f"the profiler shows no device time for {prefix}: {out}")
    return out


def phase_k2_bwd():
    """K2's backward (and the forward's lse) against the plain versions at
    the training path's shapes and at large logits, and a second launch
    bit for bit against the first; then times.  The plain and SDPA times are
    of the whole backward (dq, dk and dv); where the plan splits a loop, the
    plain (an in-order loop) and library (torch.sum) times of one sum of
    split parts."""
    import torch
    import torch.nn.functional as F
    from torch_attention_cases import TRAIN_CASES, attention_inputs
    from ssl_tpu_torch.ops import attention_cuda
    from ssl_tpu_torch.ops.attention import (attention_lse_reference, flash_attn_bwd_reference,
                                             sdp_attention_reference)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for name, (b, h, n, m, d, scale, layout, logit_range) in TRAIN_CASES.items():
        q, k, v = attention_inputs(b, h, n, m, d, scale, layout, logit_range, device="cuda")
        do = torch.randn((b, n, h, d), generator=torch.Generator(device="cuda").manual_seed(11),
                         device="cuda")
        o, lse = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
        ref_o, ref_lse = sdp_attention_reference(q, k, v, scale), attention_lse_reference(q, k, scale)
        errs = {"o": check_close(f"K2 bwd {name} o", o, ref_o, 1e-4,
                                 1e-5 * float(ref_o.abs().max())),
                "lse": check_close(f"K2 bwd {name} lse", lse, ref_lse, 1e-5, 1e-5)}
        got = attention_cuda.flash_attn_bwd_cuda(q, k, v, o, lse, do, scale)
        again = attention_cuda.flash_attn_bwd_cuda(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        for g_name, g, g2 in zip(("dq", "dk", "dv"), got, again):
            if not torch.equal(g, g2):
                fail(f"K2 bwd {name} {g_name}: a second launch differs from the first by up to "
                     f"{float((g - g2).abs().max())}")
        del again
        refs = {"reference": flash_attn_bwd_reference(q, k, v, ref_o, ref_lse, do, scale)}
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        sdp_attention_reference(*leaves, scale).backward(do)
        refs["autograd"] = [t.grad for t in leaves]
        rel = {}
        for against, ref in refs.items():
            for g_name, g, r in zip(("dq", "dk", "dv"), got, ref):
                rel[f"{g_name}_vs_{against}"] = float((g - r).norm() / r.norm())
                errs[f"{g_name}_vs_{against}"] = check_close(
                    f"K2 bwd {name} {g_name} vs {against}", g, r, BWD_RTOL,
                    BWD_ATOL * float(r.abs().max()))
        if max(rel.values()) > BWD_REL_L2:
            fail(f"K2 bwd {name}: relative L2 {rel} above {BWD_REL_L2}")
        del refs, leaves, got

        def kernel():
            attention_cuda.flash_attn_bwd_cuda(q, k, v, o, lse, do, scale)

        iters = 5 if d == 512 or n == 4096 else 20
        split = kernel_device_ms(kernel, "flash_attn_bwd", iters)
        dkv_split, dq_split, _, launches = attention_cuda.bwd_plan(b, h, n, m, d, sms)
        if set(split) != {f"{k_}_kernel" for k_ in launches if launches[k_]}:
            fail(f"K2 bwd {name}: the profiler shows kernels {sorted(split)}, the plan {launches}")
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        do_t = do.transpose(1, 2)
        kernel_ms = time_ms(kernel, iters)
        plain_ms = time_ms(lambda: flash_attn_bwd_reference(q, k, v, o, lse, do, scale), iters)
        library_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), do_t,
                                                         retain_graph=True), iters)
        bounds = k2_bwd_times(b, h, n, m, d, (dkv_split, dq_split))
        sums = {}
        if dkv_split > 1 or dq_split > 1:      # one output's parts, as the sum kernel adds them
            nparts, size = ((dkv_split, b * m * h * d) if dkv_split > 1
                            else (dq_split, b * n * h * d))
            parts = torch.randn((nparts, size), device="cuda")

            def ordered():
                out = parts[0].clone()
                for part in parts[1:]:
                    out += part
                return out

            sums = {"sum_plain_ms": time_ms(ordered, iters),
                    "sum_library_ms": time_ms(lambda: parts.sum(0), iters)}
            del parts
        results[name] = {"max_abs_err": max(errs.values()), "ms": kernel_ms,
                         "kernel_ms": {k_.removesuffix("_kernel"): v_ for k_, v_ in split.items()},
                         "launches": {k_: c for k_, c in launches.items() if c},
                         "plain_ms": plain_ms, "library_ms": library_ms, "bounds": bounds, **sums}
        emit({"phase": "kernel", "kernel": "flash_attn_bwd", "case": name,
              "b_heads_n_m_d": [b, h, n, m, d], "layout": layout, "sm_scale": scale,
              "logit_range": logit_range, "splits": [dkv_split, dq_split],
              "max_abs_err": errs, "rel_l2": rel, "repeat_bit_for_bit": True,
              "kernel_ms": kernel_ms, "kernels_device_ms": split, "plain_ms": plain_ms,
              "library_ms": library_ms, **sums,
              "bound_ms": {k_: max(v_["ops_ms"], v_["bytes_ms"]) for k_, v_ in bounds.items()},
              "fraction_of_bound": bounds["bwd"]["ops_ms"] / kernel_ms,
              "fraction_of_fp32_bound": bounds["bwd"]["fp32_ops_ms"] / kernel_ms})
        del q, k, v, o, lse, do, qt, kt, vt, sdpa_out
        torch.cuda.empty_cache()
    return results


def ssl_base_cfg() -> dict:
    """options/diffusion/ssl_base.yml's model, sslopt and train blocks as a dict
    (the card's machine has no yaml), with model.use_flash_attention on, as
    scripts/bench_diffusion_ssl.py sets it with BENCH_FLASH_ATTN=1."""
    return {
        "model": {"timesteps": 1000, "beta_schedule": "linear", "linear_start": 0.00085,
                  "linear_end": 0.012, "parameterization": "eps", "scale_factor": 0.18215,
                  "pixel_weight": 0.1, "context_dim": 1024, "use_flash_attention": True,
                  "unet": {"model_channels": 256, "num_res_blocks": 2, "channel_mult": [1, 2, 4],
                           "attention_resolutions": [4, 2, 1], "num_heads": 8},
                  "first_stage": {"embed_dim": 4, "ch": 128, "ch_mult": [1, 2, 4, 4],
                                  "num_res_blocks": 2}},
        "sslopt": {"l1_weight": 0.5, "kl_weight": 0.5, "mask_stride": 3,
                   "kernel_size_search": 25, "kernel_size_window": 9, "sigma": 0.004,
                   "generalization": True, "impl": "dense"},
        "train": {"lr": 5.0e-5, "accumulate_grad_batches": 12, "max_steps": 800000,
                  "log_every": 100, "save_every": 1000},
    }


def lq_image(size: int, up: int, seed: int):
    """A smooth synthetic LQ image (1, 3, size, size) in [0, 1], bicubically
    upsampled on the card to (1, 3, up, up) as the CLI does with cv2."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    phase = rng.rand(3, 2) * 6.0
    img = np.stack([0.5 + 0.35 * np.sin(5 * yy + 3 * xx + a) * np.cos(4 * xx - 2 * yy + b)
                    for a, b in phase])[None].astype(np.float32)
    lq = torch.from_numpy(img).cuda()
    return F.interpolate(lq, size=(up, up), mode="bicubic", align_corners=False).clamp(0, 1)


def flash_modules(state):
    """Every module with a flash switch: the VAE's, and the UNet's and the
    struct-cond encoder's in both the weights and their EMA."""
    nets = [state.frozen["vae"]] + [p[k] for p in (state.params, state.ema_params)
                                     for k in ("unet", "structcond")]
    return [m for net in nets for m in net.modules() if hasattr(m, "use_flash_attention")]


def phase_diffusion():
    """The full-width model, its zero-initialised layers drawn from a seeded
    normal scaled by fan-in (the same draws for the weights and their EMA),
    and the UNet's output std as evidence that every branch reaches it."""
    import torch
    from ssl_tpu_torch.diffusion.main import build_from_config

    t0 = time.perf_counter()
    model = build_from_config(ssl_base_cfg())
    state = model.init_state(seed=0)
    with torch.no_grad():
        for i, name in enumerate(("unet", "structcond")):
            for params in (state.params, state.ema_params):
                gen = torch.Generator(device="cuda").manual_seed(100 + i)
                for m in params[name].modules():
                    if getattr(m, "zero_init", False):
                        m.weight.normal_(generator=gen).mul_(m.weight[0].numel() ** -0.5)
        p = model.infer_params(state)
        gen = torch.Generator(device="cuda").manual_seed(5)
        z = torch.randn((1, 4, 64, 64), generator=gen, device="cuda")
        eps = model.apply_model(p, z, torch.full((1,), 500, device="cuda"),
                                p["null_context"][None], z)
    torch.cuda.synchronize()
    std = float(eps.std())
    if not (std > 0 and bool(torch.isfinite(eps).all())):
        fail(f"UNet output std {std}: the output is degenerate")
    emit({"phase": "diffusion", "config": "options/diffusion/ssl_base.yml",
          "use_flash_attention": True, "setup_s": time.perf_counter() - t0,
          "params_m": {k: sum(x.numel() for x in net.parameters()) / 1e6 for k, net in
                       (("unet", p["unet"]), ("structcond", p["structcond"]),
                        ("vae", state.frozen["vae"]))},
          "unet_out_std": std})
    return model, state


def phase_e2e(model, state):
    """One 256^2 request through the K2 route and the plain route."""
    import torch
    from ssl_tpu_torch.diffusion.test_cli import restore
    from ssl_tpu_torch.ops import attention_cuda

    lq_up = lq_image(E2E_LQ, 4 * E2E_LQ, seed=1)
    outs, launches = {}, {}
    for route, flash in (("k2", True), ("plain", False)):
        for m in flash_modules(state):
            m.use_flash_attention = flash
        before = attention_cuda.launches
        gen = torch.Generator(device="cuda").manual_seed(7)
        outs[route] = restore(model, state, lq_up, gen, "ddpm", E2E_STEPS, colorfix="nofix")
        torch.cuda.synchronize()
        launches[route] = attention_cuda.launches - before
    for m in flash_modules(state):
        m.use_flash_attention = True
    if launches != {"k2": E2E_K2_LAUNCHES, "plain": 0}:
        fail(f"e2e: K2 launches {launches}, expected {E2E_K2_LAUNCHES} on the K2 route, 0 plain")
    a, b = outs["k2"].double(), outs["plain"].double()
    if not bool(torch.isfinite(a).all()):
        fail("e2e: the K2 route's image is not finite")
    rel_l2 = float((a - b).norm() / b.norm())
    emit({"phase": "e2e", "size": 4 * E2E_LQ, "steps": E2E_STEPS, "k2_launches": launches,
          "rel_l2": rel_l2, "bound": E2E_REL_L2, "max_abs": float((a - b).abs().max()),
          "image_std": float(b.std())})
    if not rel_l2 <= E2E_REL_L2:
        fail(f"e2e: decoded images of the K2 and plain routes differ by {rel_l2} relative L2 "
             f"(bound {E2E_REL_L2})")


def phase_serve(model, state):
    """Two 512^2 requests through the CLI's ``restore``; K2 counted around them."""
    import torch
    from ssl_tpu_torch.diffusion.test_cli import restore
    from ssl_tpu_torch.ops import attention_cuda

    images = [lq_image(SERVE_LQ, SERVE_SIZE, seed=10 + i) for i in range(SERVE_REQUESTS)]
    gen = torch.Generator(device="cuda").manual_seed(42)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    requests = []
    attention_cuda.launches = 0
    attention_cuda.fwd_kernel_launches.update(dict.fromkeys(attention_cuda.fwd_kernel_launches, 0))
    for lq_up in images:
        timings = {}
        t0 = time.perf_counter()
        img = restore(model, state, lq_up, gen, "ddpm", SERVE_STEPS, timings=timings)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        ok = (tuple(img.shape) == (1, 3, SERVE_SIZE, SERVE_SIZE)
              and bool(torch.isfinite(img).all()) and 0 <= float(img.min()) <= float(img.max()) <= 1)
        if not ok:
            fail(f"serve: output {tuple(img.shape)} is wrong, not finite or outside [0, 1]")
        requests.append({"ms": 1e3 * total, "ms_per_step": 1e3 * timings["sample"] / SERVE_STEPS,
                         "vae_encode_ms": 1e3 * timings["encode"],
                         "vae_decode_ms": 1e3 * timings["decode"],
                         "colorfix_ms": 1e3 * timings["colorfix"],
                         "finite": True, "shape": list(img.shape), "std": float(img.std())})
    launches = attention_cuda.launches
    fwd_kernels = dict(attention_cuda.fwd_kernel_launches)
    expected = SERVE_REQUESTS * (K2_PER_REQUEST + SERVE_STEPS * K2_PER_STEP)
    emit({"phase": "serve", "config": "options/diffusion/ssl_base.yml", "size": SERVE_SIZE,
          "sampler": "ddpm", "steps": SERVE_STEPS, "requests": requests,
          "k2_launches": launches, "k2_expected": expected, "k2_fwd_kernel_launches": fwd_kernels,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32, "card": card()})
    if launches != expected:
        fail(f"serve: K2 launched {launches} times, expected {expected}")
    idle = [k_ for k_, c in fwd_kernels.items() if c == 0]
    if idle:
        fail(f"serve: K2 forward kernels {idle} were never launched: {fwd_kernels}")
    return launches, fwd_kernels


def train_batch(size: int, seed: int) -> dict:
    """A smooth synthetic GT (2, 3, size, size) in [0, 1] made on the card,
    its LQ (4x area-downsampled, bicubically upsampled back, as the pipeline
    hands it over), and an edge mask of density 0.25 (bench.py's)."""
    import torch
    import torch.nn.functional as F
    gt = torch.cat([lq_image(size, size, seed=seed + i) for i in range(TRAIN_B)])
    lq = F.interpolate(F.avg_pool2d(gt, 4), size=(size, size), mode="bicubic",
                       align_corners=False).clamp(0, 1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mask = (torch.rand((TRAIN_B, 1, size, size), generator=gen, device="cuda") < 0.25).float()
    return {"gt": gt, "lq": lq, "gt_mask": mask}


def reset_training(state) -> None:
    """Back to no accumulated gradient, mini-step 0 (the weights are as they
    were: no update has been applied)."""
    state.opt.zero_grad(set_to_none=True)
    state.step = state.mini_step = 0


def phase_train_e2e(model, state):
    """One mini-step at 256^2 through the K2 route and the plain route, from
    the same weights and handed-in draws; the first of 12 mini-steps leaves
    the summed gradients in .grad and the weights untouched."""
    import torch
    from ssl_tpu_torch.diffusion.ddpm_ssl import latent_shape, trainable
    from ssl_tpu_torch.ops import attention_cuda

    batch = train_batch(TRAIN_E2E_SIZE, seed=20)
    gen = torch.Generator(device="cuda").manual_seed(21)
    shape = latent_shape(state.frozen["vae"], TRAIN_B, TRAIN_E2E_SIZE, TRAIN_E2E_SIZE)
    draws = {"enc_noise": torch.randn((2 * TRAIN_B, *shape[1:]), generator=gen, device="cuda"),
             "t": torch.tensor([1, 3], device="cuda") * (model.sched.num_timesteps // 4),
             "noise": torch.randn(shape, generator=gen, device="cuda")}
    logs, grads, launches = {}, {}, {}
    for route, flash in (("k2", True), ("plain", False)):
        for m in flash_modules(state):
            m.use_flash_attention = flash
        reset_training(state)
        attention_cuda.launches = attention_cuda.bwd_launches = 0
        _, out = model.train_step(state, batch, draws)
        torch.cuda.synchronize()
        launches[route] = {"fwd": attention_cuda.launches, "bwd": attention_cuda.bwd_launches}
        logs[route] = {k: float(v) for k, v in out.items()}
        grads[route] = [p.grad.detach().clone() for p in trainable(state.params)]
    for m in flash_modules(state):
        m.use_flash_attention = True
    reset_training(state)
    if launches != {"k2": TRAIN_E2E_K2, "plain": {"fwd": 0, "bwd": 0}}:
        fail(f"train_e2e: K2 launches {launches}, expected {TRAIN_E2E_K2} on the K2 route")
    names = [f"{net}.{n}" for net in ("unet", "structcond")
             for n, _ in state.params[net].named_parameters()] + ["null_context"]
    norms = [float(g.norm()) for g in grads["plain"]]
    # a gradient below 1e-6 of the largest one is rounding noise (the
    # function does not depend on that parameter), so its relative error is
    # not a measure of the kernels; such parameters are counted, not held
    resolved = [n > 1e-6 * max(norms) for n in norms]
    rel = [float((a - b).norm() / b.norm().clamp_min(1e-30))
           for a, b in zip(grads["k2"], grads["plain"])]
    held = [r for r, ok in zip(rel, resolved) if ok]
    total = float(torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(*grads.values())))
                  / torch.sqrt(sum((b ** 2).sum() for b in grads["plain"])))
    finite = all(bool(torch.isfinite(g).all()) for g in grads["k2"])
    log_err = {k: abs(logs["k2"][k] - v) / abs(v) for k, v in logs["plain"].items()}
    worst = sorted(range(len(rel)), key=lambda i: -rel[i])[:5]
    emit({"phase": "train_e2e", "size": TRAIN_E2E_SIZE, "batch": TRAIN_B, "k2_launches": launches,
          "logs": logs, "log_rel_err": log_err, "grad_rel_l2_held_max": max(held),
          "grad_rel_l2_all": total, "n_params": len(rel), "n_unresolved": len(rel) - len(held),
          "grad_rel_l2_worst": [[names[i], rel[i], norms[i] / max(norms)] for i in worst],
          "grad_bound": TRAIN_GRAD_REL_L2, "log_bound": TRAIN_LOG_RTOL,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    if not finite or not all(map(lambda x: x == x, logs["k2"].values())):
        fail("train_e2e: the K2 route's gradients or logs are not finite")
    if max(log_err.values()) > TRAIN_LOG_RTOL:
        fail(f"train_e2e: logs differ by {log_err} (rtol {TRAIN_LOG_RTOL})")
    if max(held) > TRAIN_GRAD_REL_L2 or total > TRAIN_GRAD_REL_L2:
        fail(f"train_e2e: a parameter's gradient differs by {max(held)} relative L2, all "
             f"together by {total} (bound {TRAIN_GRAD_REL_L2})")


def phase_diffusion_train(model, state):
    """One full accumulation cycle at 512^2 through train_step; returns the
    K1, K2 forward and K2 backward launch counts of the run."""
    import numpy as np
    import torch
    from ssl_tpu_torch.diffusion.ddpm_ssl import trainable
    from ssl_tpu_torch.ops import attention_cuda, ssg_cuda

    batches = [train_batch(TRAIN_SIZE, seed=30 + 2 * i) for i in range(TRAIN_MINI_STEPS)]
    start = [p.detach().clone() for p in trainable(state.params)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssg_cuda.launches = attention_cuda.launches = attention_cuda.bwd_launches = 0
    attention_cuda.bwd_kernel_launches.update(dict.fromkeys(attention_cuda.bwd_kernel_launches, 0))
    attention_cuda.fwd_kernel_launches.update(dict.fromkeys(attention_cuda.fwd_kernel_launches, 0))
    ms, logs, k2_bwd_ms = [], [], None
    for i, batch in enumerate(batches):
        if i == TRAIN_MINI_STEPS - 1:
            ema_before = [e.clone() for e in trainable(state.ema_params)]
        t0 = time.perf_counter()
        if i == 1:            # a warm mini-step under the profiler (kept out of the warm times)
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, out = model.train_step(state, batch)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
            k2_bwd_ms = {}
            for e in events:
                short = re.search(r"flash_attn_(fwd|bwd)\w*", e.key)
                if short:
                    k2_bwd_ms[short[0]] = (k2_bwd_ms.get(short[0], 0.0)
                                           + e.self_device_time_total / 1e3)
            for way in ("fwd", "bwd"):
                k2_bwd_ms[f"flash_attn_{way}_all"] = sum(
                    v for k_, v in k2_bwd_ms.items() if k_.startswith(f"flash_attn_{way}_"))
            k2_bwd_ms["device_busy"] = sum(e.self_device_time_total for e in events) / 1e3
        else:
            _, out = model.train_step(state, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        values = {k: float(v) for k, v in out.items()}
        logs.append(values)
        if not all(np.isfinite(v) for v in values.values()):
            fail(f"diffusion_train: mini-step {i + 1} logged {values}")
        same = all(torch.equal(a, p) for a, p in zip(start, trainable(state.params)))
        if same != (i < TRAIN_MINI_STEPS - 1):
            fail(f"diffusion_train: after mini-step {i + 1} the weights "
                 f"{'did not move' if same else 'moved'}")
    launches = {"k1": ssg_cuda.launches, "k2_fwd": attention_cuda.launches,
                "k2_bwd": attention_cuda.bwd_launches}
    bwd_kernels = dict(attention_cuda.bwd_kernel_launches)
    fwd_kernels = dict(attention_cuda.fwd_kernel_launches)
    if any(torch.equal(a, e) for a, e in zip(ema_before, trainable(state.ema_params))):
        fail("diffusion_train: an EMA tensor did not move at the applying mini-step")
    n = TRAIN_MINI_STEPS
    expected = {"k1": n, "k2_fwd": n * TRAIN_K2_FWD, "k2_bwd": n * TRAIN_K2_BWD}
    emit({"phase": "diffusion_train", "config": "options/diffusion/ssl_base.yml",
          "size": TRAIN_SIZE, "batch": TRAIN_B, "mini_steps": n,
          "accumulate": model.accumulate, "lr": model.lr, "ms_first": ms[0],
          "ms_profiled": ms[1], "ms_warm_mean": sum(ms[2:-1]) / len(ms[2:-1]),
          "ms_warm": ms[2:-1], "ms_applying": ms[-1], "logs_first": logs[0], "logs_last": logs[-1],
          "launches": launches, "expected": expected, "k2_bwd_kernel_launches": bwd_kernels,
          "k2_fwd_kernel_launches": fwd_kernels,
          "device_ms_profiled_mini_step": k2_bwd_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32, "card": card()})
    if launches != expected:
        fail(f"diffusion_train: launches {launches}, expected {expected}")
    idle = [k_ for k_, c in {**bwd_kernels, **fwd_kernels}.items() if c == 0]
    if idle:
        fail(f"diffusion_train: K2 kernels {idle} were never launched: "
             f"{bwd_kernels}, {fwd_kernels}")
    return dict(launches, **bwd_kernels, **fwd_kernels)


def phase_train():
    import numpy as np
    import torch
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.ops import ssg_cuda

    model = build_model(shipped_opt(MAIN_B))
    state = model.init_state(seed=0)
    torch.cuda.reset_peak_memory_stats()
    lq_size = MAIN_GT // SCALE
    rng = np.random.RandomState(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in {
        "lq": rng.rand(MAIN_B, 3, lq_size, lq_size).astype(np.float32),
        "gt": rng.rand(MAIN_B, 3, MAIN_GT, MAIN_GT).astype(np.float32),
        "gt_mask": (rng.rand(MAIN_B, 1, MAIN_GT, MAIN_GT) < 0.25).astype(np.float32)}.items()}
    before = {name: [p.detach().clone() for p in net.parameters()]
              for name, net in (("g", state.net_g), ("d", state.net_d), ("ema", state.net_g_ema))}

    ssg_cuda.launches = 0
    state, logs = model.train_step(state, batch)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_steps = 3
    for _ in range(n_steps):
        state, logs = model.train_step(state, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_steps
    launches = ssg_cuda.launches

    if launches != n_steps + 1:
        fail(f"K1 launched {launches} times in {n_steps + 1} steps, expected one per step")
    wanted = ("l_pix", "l_percep", "l_g_gan", "l_selfsim", "l_selfsim_kl", "l_d_real", "l_d_fake")
    values = {k: float(logs[k]) for k in wanted if k in logs}
    missing = [k for k in wanted if k not in values]
    if missing:
        fail(f"losses missing from the logs: {missing}")
    if not all(np.isfinite(v) for v in values.values()):
        fail(f"non-finite loss: {values}")
    for name, net in (("g", state.net_g), ("d", state.net_d), ("ema", state.net_g_ema)):
        if all(torch.equal(a, p) for a, p in zip(before[name], net.parameters())):
            fail(f"{name} parameters did not change")
    with torch.no_grad():
        out = state.net_g_ema(batch["lq"])
    if tuple(out.shape) != (MAIN_B, 3, MAIN_GT, MAIN_GT) or not bool(torch.isfinite(out).all()):
        fail(f"EMA generator output {tuple(out.shape)} is wrong or not finite")
    emit({"phase": "train", "model": "ESRGANSSLModel", "batch": MAIN_B, "gt_size": MAIN_GT,
          "steps_timed": n_steps, "ms_per_step": 1e3 * step_s, "imgs_per_s": MAIN_B / step_s,
          "k1_launches": launches, "losses": values, "card": card(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    return launches


def kernels_line(k1, k2, k2_bwd, serve, train, launches) -> dict:
    """The {"kernels": [...]} line: one entry per kernel of the port, from the
    phases' results (K1's, K2's forward's and backward's by case, the serving
    K2 launches and forward kernel launches, the diffusion_train launch
    counts and the ESRGAN train step's K1 launches)."""
    from torch_attention_cases import TRAIN_MIX_BWD

    serve_calls, serve_fwd = serve
    both = f"{UPSTREAM_DKV}; {UPSTREAM_DQ}"
    bwd_kernels = {"dkv": UPSTREAM_DKV, "dq": UPSTREAM_DQ, "sum": both, "p_ds": both,
                   "dkv_mm": UPSTREAM_DKV, "dq_mm": UPSTREAM_DQ}

    def bwd_entry(f, replaces):
        """flash_attn_bwd_<f>: per-launch means over the launches one training
        mini-step's mix of shapes gives it (TRAIN_MIX_BWD calls per case)."""
        runs = {c: w * k2_bwd[c]["launches"][f"flash_attn_bwd_{f}"]
                for c, w in TRAIN_MIX_BWD.items()
                if f"flash_attn_bwd_{f}" in k2_bwd[c]["launches"]}
        total = sum(runs.values())

        def per_launch(value):
            return sum(TRAIN_MIX_BWD[c] * value(k2_bwd[c]) for c in runs) / total

        ops, nbytes, fp32 = (per_launch(lambda r, kind=kind: r["bounds"][f][kind])
                             for kind in ("ops_ms", "bytes_ms", "fp32_ops_ms"))

        def call_mean(key):
            return sum(TRAIN_MIX_BWD[c] * k2_bwd[c][key] for c in runs) / sum(
                TRAIN_MIX_BWD[c] for c in runs)
        entry = {"name": f"flash_attn_bwd_{f}", "route": "cuda",
                 "source": "ssl_tpu_torch/csrc/flash_attn_bwd.cu", "replaces": replaces,
                 "launches": train[f"flash_attn_bwd_{f}"],
                 "launches_by_path": {"diffusion_train": train[f"flash_attn_bwd_{f}"]},
                 "max_abs_err": max(k2_bwd[c]["max_abs_err"] for c in runs),
                 "ms": per_launch(lambda r: r["kernel_ms"][f"flash_attn_bwd_{f}"]),
                 "bound_ms": max(ops, nbytes),
                 "bound_by": "operations" if ops >= nbytes else "bytes",
                 "fp32_bound_ms": max(fp32, nbytes), "cases": sorted(runs)}
        if f == "sum":
            entry.update(plain_ms=call_mean("sum_plain_ms"), library_ms=call_mean("sum_library_ms"),
                         times_are="mean per launch over one training mini-step's mix of shapes; "
                                   "plain_ms (an in-order loop) and library_ms (torch.sum) add "
                                   "one output's split parts; max_abs_err is the whole backward's")
        else:
            entry.update(plain_ms=call_mean("plain_ms"), library_ms=call_mean("library_ms"),
                         times_are="mean per launch over one training mini-step's mix of shapes; "
                                   "plain_ms and library_ms (SDPA) time the whole backward "
                                   "(dq, dk, dv) per call at the shapes this kernel runs; "
                                   "max_abs_err is the whole backward's")
        return entry

    def fwd_entry(f):
        """flash_attn_<f>: per-launch means over the launches one serving
        request's mix of shapes (SERVE_MIX) gives it; device times from the
        profiler.  The main kernels' plain and library times are the whole
        forward's; the combine's plain time is ``combine_parts``."""
        name = f"flash_attn_{f}"
        mix = {c: w for c, w in SERVE_MIX.items() if name in k2[c]["launches"]}
        total = sum(mix.values())

        def mean(value):
            return sum(w * value(k2[c]) for c, w in mix.items()) / total

        if f == "fwd_combine":
            ops, nbytes = (mean(lambda r, kind=kind: r["combine_bounds"][kind])
                           for kind in ("ops_ms", "bytes_ms"))
            plain, library = mean(lambda r: r["combine_plain_ms"]), None
        else:
            ops, nbytes = mean(lambda r: r["ops_ms"]), mean(lambda r: r["bytes_ms"])
            plain, library = mean(lambda r: r["plain_ms"]), mean(lambda r: r["library_ms"])
        return {"name": name, "route": "cuda", "source": "ssl_tpu_torch/csrc/flash_attn_fwd.cu",
                "replaces": "ssl_tpu/ops/attention.py:28",
                "launches": serve_fwd[name] + train[name],
                "launches_by_path": {"serve": serve_fwd[name], "diffusion_train": train[name]},
                "max_abs_err": max(k2[c]["max_abs_err"] for c in mix),
                "ms": mean(lambda r: r["device_ms"][name]),
                "wrapper_ms": mean(lambda r: r["ms"]), "plain_ms": plain, "library_ms": library,
                "bound_ms": max(ops, nbytes), "bound_by": "operations" if ops >= nbytes else "bytes",
                "cases": sorted(mix),
                "times_are": "mean per launch over one serving request's mix of shapes; ms is "
                             "the kernel's device time (profiler), wrapper_ms the call's (CUDA "
                             "events); max_abs_err is the whole forward's"}

    k1_runs = {"main_path": launches, "diffusion_smooth": train["k1"]}

    def k1_mean(key):
        return sum(w * k1[c][key] for c, w in k1_runs.items()) / sum(k1_runs.values())

    return {"kernels": [{
        "name": "ssg_loss_fwd", "route": "cuda", "source": "ssl_tpu_torch/csrc/ssg_loss_fwd.cu",
        "replaces": "ssl_tpu/ops/ssg_pallas.py:41", "launches": launches + train["k1"],
        "launches_by_path": {"esrgan_train": launches, "diffusion_train": train["k1"]},
        "max_abs_err": max(k1[c]["max_abs_err"] for c in ("main_smooth", "diffusion_smooth")),
        "ms": k1_mean("device_ms"), "wrapper_ms": k1_mean("ms"), "plain_ms": k1_mean("plain_ms"),
        "bound_ms": k1_mean("bound_ms"), "bound_by": k1["main_path"]["bound_by"],
        "library_ms": None,
        "ms_by_shape": {"b16_3x128^2": k1["main_path"]["device_ms"],
                        "b2_3x512^2": k1["diffusion_smooth"]["device_ms"]},
        "times_are": "mean per launch over the run's launches (b16 3x128^2 in the ESRGAN "
                     "step, b2 3x512^2 in the diffusion mini-step); ms is the kernel's device "
                     "time (profiler), wrapper_ms the call's (CUDA events); max_abs_err on "
                     "smooth images"},
        *(fwd_entry(f) for f in ("fwd", "fwd_d512", "fwd_combine")),
        *(bwd_entry(f, replaces) for f, replaces in bwd_kernels.items())]}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "ssl_tpu_torch")):
        print("chip_smoke: ssl_tpu_torch/ is not beside this script; run it from the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    sys.path.insert(0, os.path.join(ROOT, "tests"))      # torch_attention_cases (JAX-free)
    phase_build()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k1 = phase_kernel()
    k2 = phase_k2()
    k2_bwd = phase_k2_bwd()
    model, state = phase_diffusion()
    phase_e2e(model, state)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    serve = phase_serve(model, state)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    phase_train_e2e(model, state)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    train = phase_diffusion_train(model, state)
    del model, state
    torch.cuda.empty_cache()
    launches = phase_train()

    emit(kernels_line(k1, k2, k2_bwd, serve, train, launches))
    print(card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
