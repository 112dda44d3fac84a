"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; the first failure exits non-zero:

1. build   compile the port's CUDA kernels (K1 ssg_loss_fwd, K2
           flash_attn_fwd and flash_attn_bwd) with nvcc, one process per
           source, all at once
2. kernel  hold K1 (ssl_tpu_torch/csrc/ssg_loss_fwd.cu) against its plain
           PyTorch version on the card: a small case (search 9, window 5),
           the shipped search 25 / window 9 / sigma 0.004 on smooth images
           at 32^2, at the ESRGAN step's shape (b16, 3x128^2), at the
           diffusion mini-step's (b2, 3x512^2) and at the RealESRGAN-SSL
           step's (b12, 3x400^2, with real edge masks), and the ESRGAN
           step's own inputs (bench.py's uniform images, on which every off-centre q is
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
9. cli     the ESRGAN-SSL train and test CLIs (ssl_tpu_torch.train /
           ssl_tpu_torch.test) at the same widths on files: 24 GT PNGs of
           192^2 written through utils/png.py, their LQ and .mat edge masks
           made on the card, read by 4 loader processes; a .json option file
           with the shipped YAML's values; 4 iterations (K1 once each) with
           validation (PSNR/SSIM) and checkpoints, with cv2 hidden so that
           PNG decodes through utils/png.py; the training state reloaded into
           a fresh model bit for bit; --auto_resume to 6 (K1 twice more,
           decoding with cv2 where it imports); the test CLI on net_g_6.pth
           whole and tiled; times per iteration and the loader's data wait
           from the logger's timers, and the loader alone with each decoder
10. realesrgan  the RealESRGAN-SSL train and test CLIs at the shipped widths
           (RRDBNet 64/23/32, UNetDiscriminatorSN 64, VGG19 at five layers,
           SSL 25/9/0.004) on files: 24 GT PNGs of 512^2 made on the card,
           their .mat masks from the generate_mask entry point, a .json
           option file with the shipped YAML's values (batch 12, crop_pre
           400, 6 loader processes; the pool cut to 24 slots); 4 iterations
           (each degrades the batch on the card, makes the USM target and
           passes the pool; K1 once each; the pool pointer 24 after 2), the
           training state reloaded bit for bit with the pool and the
           generators, --auto_resume to 6, the test CLI on a BlindLR-style
           set (PSNR/SSIM); the degradation + USM + pool timed alone, and
           the degradation held card against CPU with TF32 off.  K1 is also
           held at its shape (b12, 3x400^2) in the kernel phase, on
           pictures with real edge masks
11. kernels one line per ported kernel: launches on its main paths, error
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
# The train and test CLIs on files: CLI_TRAIN GT images of CLI_GT^2 with their
# LQ and masks, read by CLI_WORKERS loader processes, each image CLI_ENLARGE
# times an epoch (dataset_enlarge_ratio) so that the run stays in one epoch, as
# a real set's would (with 1, each iteration would open an epoch and wait for
# its first batch); CLI_ITERS iterations at batch MAIN_B, then --auto_resume to
# CLI_RESUME_ITERS; val pairs of these GT sizes (LQ 48 x 48 and 44 x 36: the
# second is no multiple of 16); the tiled test run's tile and halo.
CLI_TRAIN, CLI_GT, CLI_WORKERS, CLI_ENLARGE = 24, 192, 4, 4
CLI_ITERS, CLI_RESUME_ITERS = 4, 6
CLI_VAL = ((192, 192), (176, 144))
CLI_TILE = (24, 8)
CLI_METRICS = {"psnr": {"type": "calculate_psnr", "crop_border": 4, "test_y_channel": True},
               "ssim": {"type": "calculate_ssim", "crop_border": 4, "test_y_channel": True}}


# RealESRGAN-SSL (options/train/RealESRGANSSL/train_RealESRGANSSL_x4.yml):
# RE_TRAIN GT sub-images of RE_GT_IMG^2 (the YAML's multiscale_HR_sub_512),
# cropped to RE_CROP (crop_pre), batch RE_B, RE_WORKERS loader processes;
# the training-pair pool cut from the YAML's 180 slots to RE_QUEUE so that
# iterations 3-4 take its full branch (180 would fill for 15 iterations);
# each image RE_ENLARGE times an epoch so that the 6 iterations stay in one
# epoch, as a real set's would; RE_ITERS iterations, then --auto_resume to
# RE_RESUME_ITERS; a BlindLR-style test set of RE_TEST_GT GT images of
# RE_TEST_SIZE, each with the LQ variants of RE_VARIANTS.
RE_TRAIN, RE_GT_IMG, RE_CROP, RE_B, RE_WORKERS = 24, 512, 400, 12, 6
RE_QUEUE, RE_ENLARGE, RE_ITERS, RE_RESUME_ITERS = 24, 3, 4, 6
RE_TEST_GT, RE_TEST_SIZE, RE_VARIANTS = 2, (256, 192), ("bicubic", "area_noise")
# The degradation hold, card against CPU, TF32 off: each stage is float32
# convolutions, resizes and 8x8 DCTs summed in other orders, so the output
# may move by one uint8 level where a value, or a JPEG coefficient, lies
# within rounding of a half-integer; at most RE_TIE_SHARE of the values may.
RE_TIE_SHARE = 1e-3


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


def edge_case(b, h, seed):
    """The RealESRGAN-SSL step's K1 inputs: GT pictures made on the card
    (``smooth_picture``: smooth fields, sharp-edged blocks, light noise), their
    real edge masks (``edge_mask_torch``, threshold 20, as generate_mask
    writes them) and SR = GT + N(0, 0.1^2)."""
    import torch
    from ssl_tpu_torch.ops.edge_mask import edge_mask_torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gt = torch.stack([smooth_picture(h, h, gen, "cuda") for _ in range(b)]) / 255
    mask = edge_mask_torch(gt, 20.0)[:, 0]
    sr = gt + 0.1 * torch.randn(gt.shape, generator=gen, device="cuda")
    return tuple(t.contiguous().cpu().numpy() for t in (sr, gt, mask))


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
             ("diffusion_smooth", smooth_case(TRAIN_B, TRAIN_SIZE, 4, 0.25), shipped, 1e-4),
             ("realesrgan_edges", edge_case(RE_B, RE_CROP, 6), shipped, 1e-4)]
    results = {}
    for name, arrays, cfg, map_rtol in cases:
        sr, gt, mask = (torch.from_numpy(a).cuda() for a in arrays)
        errs, ties = hold_k1(name, sr, gt, mask, cfg, map_rtol, ssg_cuda.ssg_loss_fwd_cuda)
        first, again = (ssg_cuda.ssg_loss_fwd_cuda(sr, gt, mask, cfg) for _ in range(2))
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            fail(f"K1 {name}: a second launch differs from the first")
        del first, again
        one = torch.ones((), device="cuda")
        iters = 20 if sr.shape[0] == MAIN_B or sr.shape[-1] in (TRAIN_SIZE, RE_CROP) else 50
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


def smooth_picture(h: int, w: int, gen, device: str):
    """A seeded (3, h, w) RGB image on uint8 levels, made on ``device``:
    smooth colour fields with three sharp-edged blocks and light noise."""
    import torch
    yy = torch.linspace(0, 1, h, device=device)[:, None]
    xx = torch.linspace(0, 1, w, device=device)[None]
    f = torch.rand(3, 4, generator=gen, device=device) * 6 + 1
    img = torch.stack([0.5 + 0.25 * torch.sin(f[c, 0] * yy + f[c, 1] * xx + f[c, 2])
                       * torch.cos(f[c, 3] * xx) for c in range(3)])
    for _ in range(3):                                    # sharp-edged blocks
        y0, x0 = (torch.rand(2, generator=gen, device=device) * 0.7).tolist()
        img[:, int(y0 * h):int((y0 + 0.25) * h), int(x0 * w):int((x0 + 0.25) * w)] = \
            torch.rand(3, 1, 1, generator=gen, device=device)
    img = img + 0.02 * torch.randn(img.shape, generator=gen, device=device)
    return torch.round(img.clamp(0, 1) * 255)                           # (3, h, w), uint8 values


def cli_fixtures(root: str, device: str) -> tuple[dict, list]:
    """The CLI's data, written under ``root``: CLI_TRAIN seeded GT images of
    CLI_GT^2 (smooth fields with sharp-edged blocks) as PNG through
    ``utils/png.py``; their LQ made on the card (antialiased bicubic down by
    SCALE, rounded to uint8); ``.mat`` masks from ``edge_mask_torch`` on the
    card (threshold 20); and CLI_VAL pairs, one of whose LQ sides is not a
    multiple of 16.  Returns the folders by name and the count of the GT
    files' rows by PNG filter type (Average and Paeth rows decode pixel by
    pixel without cv2)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from scipy.io import savemat
    from ssl_tpu_torch.ops.edge_mask import edge_mask_torch
    from ssl_tpu_torch.utils.png import encode_png, row_filters

    d = {k: os.path.join(root, k) for k in ("gt", "lq", "mask", "vgt", "vlq")}
    for path in d.values():
        os.makedirs(path)
    gen = torch.Generator(device=device).manual_seed(0)

    def picture(h, w):
        return smooth_picture(h, w, gen, device)

    def save(img_u8, path):                               # (3, h, w) RGB -> BGR PNG
        data = encode_png(img_u8.byte().cpu().numpy().transpose(1, 2, 0)[..., ::-1])
        with open(path, "wb") as f:
            f.write(data)
        return data

    def down(gt_u8):
        lq = F.interpolate(gt_u8[None] / 255, scale_factor=1 / SCALE, mode="bicubic",
                           antialias=True, align_corners=False)[0]
        return torch.round(lq.clamp(0, 1) * 255)

    filters = np.zeros(5, np.int64)
    for i in range(CLI_TRAIN):
        gt = picture(CLI_GT, CLI_GT)
        filters += np.bincount(row_filters(save(gt, os.path.join(d["gt"], f"{i:04d}.png"))),
                               minlength=5)
        save(down(gt), os.path.join(d["lq"], f"{i:04d}.png"))
        mask = edge_mask_torch(gt[None] / 255, 20.0)[0, 0]
        savemat(os.path.join(d["mask"], f"{i:04d}.mat"),
                {"mat": mask.cpu().numpy().astype(np.float64)})
    for i, (h, w) in enumerate(CLI_VAL):
        gt = picture(h, w)
        save(gt, os.path.join(d["vgt"], f"val{i}.png"))
        save(down(gt), os.path.join(d["vlq"], f"val{i}.png"))
    return d, filters.tolist()


def cli_opt(d: dict, batch: int) -> dict:
    """options/train/ESRGANSSL/train_ESRGANSSL_bicubic_x4.yml's values
    (``shipped_opt``) with the data of ``cli_fixtures`` and this phase's
    counts: CLI_ITERS iterations, a log line at each, validation and a
    checkpoint at the last, no tensorboard."""
    opt = shipped_opt(batch)
    opt.update({"tile_process": False, "tile_size": 800, "tile_pad": 32})
    opt["datasets"] = {
        "train": {"name": "DF2K_OST", "type": "PairedImageMaskDataset",
                  "dataroot_gt": d["gt"], "dataroot_lq": d["lq"], "dataroot_gt_mask": d["mask"],
                  "filename_tmpl": "{}", "io_backend": {"type": "disk"}, "gt_size": MAIN_GT,
                  "use_hflip": True, "use_rot": True, "num_worker_per_gpu": CLI_WORKERS,
                  "batch_size_per_gpu": batch, "dataset_enlarge_ratio": CLI_ENLARGE},
        "val": {"name": "DIV2K100", "type": "PairedImageDataset", "dataroot_gt": d["vgt"],
                "dataroot_lq": d["vlq"], "io_backend": {"type": "disk"}}}
    opt["path"]["resume_state"] = None
    opt["train"]["total_iter"] = CLI_ITERS
    opt["val"] = {"val_freq": CLI_ITERS, "save_img": None, "metrics": CLI_METRICS}
    opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": CLI_ITERS, "use_tb_logger": False}
    return opt


class Spy:
    """Wraps methods of a class to record their results and their time (each
    call ends in a synchronise on the card); ``restore`` puts them back."""

    def __init__(self, cls, names, device):
        import torch
        self.cls, self.calls, self.saved = cls, {n: [] for n in names}, {}
        for name in names:
            orig = getattr(cls, name)
            self.saved[name] = orig

            def wrapped(*args, _orig=orig, _name=name, **kw):
                t0 = time.perf_counter()
                out = _orig(*args, **kw)
                if device == "cuda":
                    torch.cuda.synchronize()
                self.calls[_name].append((time.perf_counter() - t0, out))
                return out
            setattr(cls, name, wrapped)

    def restore(self):
        for name, orig in self.saved.items():
            setattr(self.cls, name, orig)


def per_iter_ms(logged, key):
    """Mean ms per iteration of a logger timer over iterations 2.. of a run:
    the AvgTimer's running means at the first and last log line, unfolded."""
    first, last = logged[0], logged[-1]
    n = last["iter"] - first["iter"]
    k0, k1 = first["iter"] - first["start"], last["iter"] - first["start"]
    return 1e3 * (k1 * last[key] - k0 * first[key]) / n


class without_cv2:
    """Hide ``cv2`` while the block runs (the loader's worker processes, forked
    inside it, inherit that): images then decode through
    ``ssl_tpu_torch/utils/png.py``, as on a machine without ``cv2``."""

    def __enter__(self):
        self.saved = sys.modules.get("cv2", False)
        sys.modules["cv2"] = None

    def __exit__(self, *exc):
        if self.saved is False:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = self.saved


def decoder() -> str:
    """What ``utils/img_util.py`` decodes with here."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return "ssl_tpu_torch/utils/png.py"
    return "cv2"


def loader_alone_ms(opt: dict, device: str) -> float:
    """ms per batch of the train loader alone (CLI_WORKERS processes, pinned
    batches, no step), over the batches after the first of one epoch."""
    import gc
    from ssl_tpu_torch.data import EnlargedSampler, build_dataloader, build_dataset
    dopt = dict(opt["datasets"]["train"], phase="train", scale=SCALE)
    dataset = build_dataset(dopt)
    loader = build_dataloader(dataset, dopt, EnlargedSampler(len(dataset), 1, 0, CLI_ENLARGE),
                              seed=opt["manual_seed"], device=device)
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    n = sum(1 for _ in it)
    ms = 1e3 * (time.perf_counter() - t0) / n
    del it, loader
    gc.collect()
    return ms


def phase_cli(device: str = "cuda"):
    """The ESRGAN-SSL train and test CLIs (``ssl_tpu_torch.train`` /
    ``ssl_tpu_torch.test``) at full width on the ``cli_fixtures`` data, through
    their pipelines in this process: CLI_ITERS iterations with validation and
    checkpoints; the training state reloaded into a fresh model and held bit for
    bit; ``--auto_resume`` to CLI_RESUME_ITERS; then the test CLI on the last
    ``net_g`` (``params_ema``), whole and with ``tile_process``.  K1 must launch
    once per iteration."""
    import gc
    import tempfile

    import numpy as np
    import torch
    import ssl_tpu_torch.test as test_cli
    import ssl_tpu_torch.train as train_cli
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.models.base_model import BaseModel
    from ssl_tpu_torch.models.sr_model import SRModel
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.utils import logger as logger_mod

    with tempfile.TemporaryDirectory(prefix="cli_smoke_") as root:
        t0 = time.perf_counter()
        d, gt_filters = cli_fixtures(os.path.join(root, "data"), device)
        fixtures_s = time.perf_counter() - t0
        opt = cli_opt(d, MAIN_B)
        opt_path = os.path.join(root, "train_cli.json")
        with open(opt_path, "w") as f:
            json.dump(opt, f)
        dev = ["--device", device] if device != "cuda" else []

        def run(args):
            """One train CLI run; returns its state, logged lines, K1 launches,
            validation and checkpoint calls and wall seconds."""
            logged = []
            log_call = logger_mod.MessageLogger.__call__

            def record(self, log_vars):
                logged.append(dict(log_vars, start=self.start_iter))
                return log_call(self, log_vars)
            logger_mod.MessageLogger.__call__ = record
            spies = (Spy(SRModel, ["validation"], device),
                     Spy(BaseModel, ["save_networks", "save_training_state"], device))
            try:
                ssg_cuda.launches = 0
                t0 = time.perf_counter()
                state = train_cli.train_pipeline(root, ["-opt", opt_path] + dev + args)
                if device == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = ssg_cuda.launches
            finally:
                logger_mod.MessageLogger.__call__ = log_call
                for spy in spies:
                    spy.restore()
            gc.collect()                                  # the loader's workers end here
            return state, logged, launches, {**spies[0].calls, **spies[1].calls}, wall

        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with without_cv2():                               # the PNG path a cv2-less card takes
            decoders = {"train": decoder()}
            state, logged, launches, calls, wall = run([])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None
        exp = os.path.join(root, "experiments", opt["name"])
        if launches != CLI_ITERS:
            fail(f"cli: K1 launched {launches} times in {CLI_ITERS} iterations")
        if [x["iter"] for x in logged] != list(range(1, CLI_ITERS + 1)):
            fail(f"cli: logged iterations {[x['iter'] for x in logged]}")
        loss_keys = ("l_pix", "l_percep", "l_g_gan", "l_selfsim", "l_selfsim_kl", "l_d_real",
                     "l_d_fake")
        for x in logged:
            bad = {k: x.get(k) for k in loss_keys if not np.isfinite(x.get(k, np.nan))}
            if bad:
                fail(f"cli: iteration {x['iter']}: losses missing or not finite: {bad}")
        val = [out for _, out in calls["validation"]]
        if len(val) != 1 or set(val[0]) != set(CLI_METRICS) or \
                not all(np.isfinite(v) for v in val[0].values()):
            fail(f"cli: validation results {val}")
        for f in (f"models/net_g_{CLI_ITERS}.pth", f"models/net_d_{CLI_ITERS}.pth",
                  f"training_states/{CLI_ITERS}.state"):
            if not os.path.isfile(os.path.join(exp, f)):
                fail(f"cli: {f} was not written")

        # the training state, reloaded into a fresh model, bit for bit
        fresh = build_model(dict(opt, is_train=True), device=device)
        reloaded, it = fresh.load_training_state(fresh.init_state(seed=1),
                                                 os.path.join(exp, "training_states"), CLI_ITERS)
        n_tensors = 0
        for name in ("net_g", "net_g_ema", "net_d"):
            want = getattr(state, name).state_dict()
            for k, v in getattr(reloaded, name).state_dict().items():
                n_tensors += 1
                if not torch.equal(v, want[k]):
                    fail(f"cli: reloaded {name}.{k} differs from the saved state")
        for name in ("opt_g", "opt_d"):
            want = getattr(state, name).state_dict()["state"]
            for pid, st in getattr(reloaded, name).state_dict()["state"].items():
                for k, v in st.items():
                    n_tensors += 1
                    if not torch.equal(v, want[pid][k]):
                        fail(f"cli: reloaded {name} state {pid}.{k} differs")
        if it != CLI_ITERS or reloaded.step != state.step:
            fail(f"cli: reloaded iteration {it}, step {reloaded.step} vs {state.step}")
        del fresh, reloaded, state
        gc.collect()

        decoders["resumed"] = decoder()
        resumed, logged_r, launches_r, _, wall_r = run(
            ["--auto_resume", "--force_yml", f"train:total_iter={CLI_RESUME_ITERS}"])
        if [x["iter"] for x in logged_r] != list(range(CLI_ITERS + 1, CLI_RESUME_ITERS + 1)):
            fail(f"cli: the resumed run logged iterations {[x['iter'] for x in logged_r]}")
        if launches_r != CLI_RESUME_ITERS - CLI_ITERS or resumed.step != CLI_RESUME_ITERS:
            fail(f"cli: the resumed run launched K1 {launches_r} times, ended at step "
                 f"{resumed.step}")
        del resumed
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        loader_ms = {decoders["resumed"]: loader_alone_ms(opt, device)}
        with without_cv2():
            loader_ms[decoder()] = loader_alone_ms(opt, device)

        test_opt = {"name": "test_ESRGANSSL_bicubic_x4", "model_type": "ESRGANSSLModel",
                    "scale": SCALE, "num_devices": 1, "manual_seed": 0,
                    "datasets": {"test_1": dict(opt["datasets"]["val"], name="val_pairs")},
                    "network_g": opt["network_g"],
                    "path": {"pretrain_network_g": os.path.join(
                        exp, "models", f"net_g_{CLI_RESUME_ITERS}.pth"),
                        "param_key_g": "params_ema"},
                    "val": {"save_img": True, "metrics": CLI_METRICS}}
        test_path = os.path.join(root, "test_cli.json")
        with open(test_path, "w") as f:
            json.dump(test_opt, f)
        tests = {}
        for label, extra in (("whole", []), ("tiled", [
                "--force_yml", "name=test_tiled", "tile_process=true",
                f"tile_size={CLI_TILE[0]}", f"tile_pad={CLI_TILE[1]}"])):
            t0 = time.perf_counter()
            out = test_cli.test_pipeline(root, ["-opt", test_path] + dev + extra)["val_pairs"]
            if device == "cuda":
                torch.cuda.synchronize()
            tests[label] = dict(out, seconds=time.perf_counter() - t0)
            if set(out) != set(CLI_METRICS) or not all(np.isfinite(v) for v in out.values()):
                fail(f"cli: test CLI ({label}) metrics {out}")
        saved_imgs = sorted(os.listdir(os.path.join(root, "results", "test_tiled",
                                                    "visualization", "val_pairs")))
        if len(saved_imgs) != len(CLI_VAL):
            fail(f"cli: the tiled test run saved {saved_imgs}")

    result = {
        "phase": "cli", "train_images": CLI_TRAIN, "gt_image": CLI_GT, "batch": MAIN_B,
        "gt_size": MAIN_GT, "workers": CLI_WORKERS, "fixtures_s": fixtures_s,
        "decoders": decoders, "gt_png_rows_by_filter": gt_filters,
        "iterations": CLI_ITERS, "iterations_timed": CLI_ITERS - 1,
        "ms_per_iter": per_iter_ms(logged, "time"),
        "data_wait_ms_per_iter": per_iter_ms(logged, "data_time"),
        "first_iter_ms": 1e3 * logged[0]["time"], "first_data_wait_ms": 1e3 * logged[0]["data_time"],
        "resumed_ms_per_iter": per_iter_ms(logged_r, "time"),
        "resumed_data_wait_ms_per_iter": per_iter_ms(logged_r, "data_time"),
        "loader_alone_ms_per_batch": loader_ms,
        "wall_s": wall, "resumed_wall_s": wall_r, "peak_mem_gb": peak_gb,
        "k1_launches": {"train": launches, "resumed": launches_r},
        "losses_last_iter": {k: logged[-1][k] for k in loss_keys},
        "validation": val[0], "validation_ms": 1e3 * calls["validation"][0][0],
        "save_networks_ms": [1e3 * t for t, _ in calls["save_networks"]],
        "save_training_state_ms": [1e3 * t for t, _ in calls["save_training_state"]],
        "reloaded_tensors_bit_for_bit": n_tensors, "resumed_from": CLI_ITERS,
        "test": tests, "tile": list(CLI_TILE), "card": card() if device == "cuda" else None}
    emit(result)
    return launches + launches_r


def realesrgan_opt(d: dict) -> dict:
    """options/train/RealESRGANSSL/train_RealESRGANSSL_x4.yml's values (a
    dict: the card's machine may lack yaml) with the data of
    ``realesrgan_fixtures`` and this phase's cuts (``queue_size`` RE_QUEUE,
    ``dataset_enlarge_ratio`` RE_ENLARGE, RE_ITERS iterations, a log line at
    each, no tensorboard)."""
    kernels = ["iso", "aniso", "generalized_iso", "generalized_aniso", "plateau_iso",
               "plateau_aniso"]
    probs = [0.45, 0.25, 0.12, 0.03, 0.12, 0.03]
    return {
        "name": "RealESRGANSSL_x4", "model_type": "RealESRGANSSLModel", "scale": SCALE,
        "num_devices": 1, "manual_seed": 0, "degradation_order": "two", "queue_size": RE_QUEUE,
        "degradation_device": True,
        "resize_prob": [0.2, 0.7, 0.1], "resize_range": [0.15, 1.5], "gaussian_noise_prob": 0.5,
        "noise_range": [1, 30], "poisson_scale_range": [0.05, 3], "gray_noise_prob": 0.4,
        "jpeg_range": [30, 95], "second_blur_prob": 0.8, "resize_prob2": [0.3, 0.4, 0.3],
        "resize_range2": [0.3, 1.2], "gaussian_noise_prob2": 0.5, "noise_range2": [1, 25],
        "poisson_scale_range2": [0.05, 2.5], "gray_noise_prob2": 0.4, "jpeg_range2": [30, 95],
        "datasets": {"train": {
            "name": "DF2K_OST_mask", "type": "MyRealESRGANImageMaskDataset",
            "dataroot_gt": d["gt"], "dataroot_gt_mask": d["mask"], "crop_pre": RE_CROP,
            "blur_kernel_size": 21, "kernel_list": kernels, "kernel_prob": probs,
            "sinc_prob": 0.1, "blur_sigma": [0.2, 3], "betag_range": [0.5, 4],
            "betap_range": [1, 2], "blur_kernel_size2": 21, "kernel_list2": kernels,
            "kernel_prob2": probs, "sinc_prob2": 0.1, "blur_sigma2": [0.2, 1.5],
            "betag_range2": [0.5, 4], "betap_range2": [1, 2], "final_sinc_prob": 0.8,
            "gt_size": 256, "use_hflip": True, "use_rot": True,
            "num_worker_per_gpu": RE_WORKERS, "batch_size_per_gpu": RE_B,
            "dataset_enlarge_ratio": RE_ENLARGE}},
        "network_g": {"type": "RRDBNet", "num_in_ch": 3, "num_out_ch": 3, "num_feat": 64,
                      "num_block": 23, "num_grow_ch": 32},
        "network_d": {"type": "UNetDiscriminatorSN", "num_in_ch": 3, "num_feat": 64,
                      "skip_connection": True},
        "path": {"pretrain_network_g": None, "param_key_g": "params_ema", "resume_state": None},
        "ssl_setting": {"mask_stride": 3, "impl": "dense", "kernel_size_search": 25,
                        "sigma": 0.004, "kernel_size_window": 9, "generalization": True},
        "train": {
            "ema_decay": 0.999,
            "optim_g": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "optim_d": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [400000], "gamma": 0.5},
            "total_iter": RE_ITERS, "warmup_iter": -1,
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0, "reduction": "mean"},
            "selfsim_opt": {"type": "L1Loss", "loss_weight": 1e3, "reduction": "mean"},
            "selfsim1_opt": {"type": "KLDistanceLoss", "loss_weight": 1e3, "reduction": "mean",
                             "softmax": False},
            "perceptual_opt": {"type": "PerceptualLoss",
                               "layer_weights": {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1,
                                                 "conv4_4": 1, "conv5_4": 1},
                               "vgg_type": "vgg19", "use_input_norm": True,
                               "perceptual_weight": 1.0, "style_weight": 0, "range_norm": False,
                               "criterion": "l1"},
            "gan_opt": {"type": "GANLoss", "gan_type": "vanilla", "real_label_val": 1.0,
                        "fake_label_val": 0.0, "loss_weight": 1e-1},
            "net_d_iters": 1, "net_d_init_iters": 0},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 5000, "use_tb_logger": False},
    }


def realesrgan_fixtures(root: str, device: str) -> tuple[dict, float]:
    """RE_TRAIN GT PNGs of RE_GT_IMG^2 made on the card (``smooth_picture``)
    and written with cv2 where it imports (else ``utils/png.py``); their
    ``.mat`` masks from the port's ``generate_mask`` entry point at threshold
    20; and a BlindLR-style test set: RE_TEST_GT GT images, each with one LQ
    per variant of RE_VARIANTS made on the card (antialiased bicubic down by
    SCALE; area down by SCALE plus Gaussian noise of sigma 5 levels), rounded
    to uint8.  Returns the folders and the masks' share of edge pixels."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from ssl_tpu_torch.scripts import generate_mask
    from ssl_tpu_torch.utils.img_util import imwrite

    d = {k: os.path.join(root, k) for k in ("gt", "test_gt", "test_lq")}
    for path in d.values():
        os.makedirs(path)
    gen = torch.Generator(device=device).manual_seed(1)

    def save(img_u8, path):                               # (3, h, w) RGB -> BGR file
        imwrite(np.ascontiguousarray(img_u8.byte().cpu().numpy().transpose(1, 2, 0)[..., ::-1]),
                path)

    for i in range(RE_TRAIN):
        save(smooth_picture(RE_GT_IMG, RE_GT_IMG, gen, device),
             os.path.join(d["gt"], f"{i:04d}.png"))
    d["mask"] = generate_mask.main(["--input", d["gt"], "--output", os.path.join(root, "masks"),
                                    "--threshold", "20"])
    stats = os.path.join(os.path.dirname(d["mask"]), "edge_pixel_stats.txt")
    with open(stats) as f:
        shares = [float(line.split()[2]) for line in f if line.strip()]
    h, w = RE_TEST_SIZE
    for i in range(RE_TEST_GT):
        gt = smooth_picture(h, w, gen, device)
        save(gt, os.path.join(d["test_gt"], f"t{i}.png"))
        x = gt[None] / 255
        lqs = {"bicubic": F.interpolate(x, scale_factor=1 / SCALE, mode="bicubic",
                                        antialias=True, align_corners=False),
               "area_noise": F.interpolate(x, scale_factor=1 / SCALE, mode="area")
               + 5 / 255 * torch.randn((1, 3, h // SCALE, w // SCALE), generator=gen,
                                       device=device)}
        for variant in RE_VARIANTS:
            os.makedirs(os.path.join(d["test_lq"], variant), exist_ok=True)
            save(torch.round(lqs[variant][0].clamp(0, 1) * 255),
                 os.path.join(d["test_lq"], variant, f"t{i}.png"))
    return d, float(np.mean(shares))


def draws_to(draws, device):
    """A ``DegradeDraws`` with its tensors on ``device``."""
    import torch

    def move(stage):
        return stage._replace(**{k: v.to(device) for k, v in stage._asdict().items()
                                 if torch.is_tensor(v)})
    return draws._replace(stage1=move(draws.stage1), stage2=move(draws.stage2),
                          jpeg1=draws.jpeg1.to(device), jpeg2=draws.jpeg2.to(device))


def poisson_icdf(rate, u):
    """Poisson(rate) samples by inversion of given uniforms ``u`` (float64):
    the least k with P(X <= k) = Q(k + 1, rate) >= u, by bisection.  Each
    element depends on its own rate and uniform only, so two devices give
    the same samples from the same uniforms (a sampler that consumes a
    generator element by element would shift every later sample where one
    rate differs in its last bit)."""
    import torch
    lam = rate.double()
    lo = torch.zeros_like(lam)
    hi = torch.ceil(lam + 12 * lam.sqrt() + 12)
    while bool((lo < hi).any()):
        mid = torch.floor((lo + hi) / 2)
        below = torch.special.gammaincc(mid + 1, lam) < u
        lo, hi = torch.where(below, mid + 1, lo), torch.where(below, hi, mid)
    return lo.to(rate.dtype)


def degradation_hold(batch: dict, cfg) -> dict:
    """One fixed ``DegradeDraws`` through ``degrade_two_stage`` on the card
    and on the CPU with TF32 off: at most one uint8 level apart, on at most
    RE_TIE_SHARE of the values, equal elsewhere.  The Poisson samples invert
    uniforms drawn on the CPU from generators seeded by stage and kind
    (``poisson_icdf``), so both sides draw them alike from their own rates.
    Both noise families are held: the draws are made twice, with Gaussian
    and with Poisson noise forced in both stages."""
    import torch
    from ssl_tpu_torch.ops.degrade import degrade_two_stage, draw_degradation

    def poisson(rate, stage, which):
        g = torch.Generator().manual_seed(10 * stage + (which == "gray"))
        u = torch.rand(rate.shape, generator=g, dtype=torch.float64)
        return poisson_icdf(rate, u.to(rate.device))

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cpu = {k: batch[k].cpu() for k in ("gt", "kernel1", "kernel2", "sinc_kernel")}
    out = {}
    try:
        for family, p in (("gaussian", 1.0), ("poisson", 0.0)):
            fcfg = cfg._replace(gaussian_noise_prob=p, gaussian_noise_prob2=p)
            draws = draw_degradation(fcfg, RE_B, RE_CROP, torch.Generator().manual_seed(7),
                                     torch.Generator().manual_seed(8))._replace(poisson=poisson)
            on_cpu = degrade_two_stage(cpu["gt"], cpu["kernel1"], cpu["kernel2"],
                                       cpu["sinc_kernel"], fcfg, draws)
            on_card = degrade_two_stage(batch["gt"], batch["kernel1"], batch["kernel2"],
                                        batch["sinc_kernel"], fcfg,
                                        draws_to(draws, batch["gt"].device))
            levels = (torch.round(on_card.cpu() * 255) - torch.round(on_cpu * 255)).abs()
            share = float((levels > 0).float().mean())
            if float(levels.max()) > 1 or share > RE_TIE_SHARE:
                fail(f"realesrgan: the {family} degradation on the card is {float(levels.max())} "
                     f"levels from the CPU's on {share} of the values (hold: 1 level on at most "
                     f"{RE_TIE_SHARE})")
            out[family] = {"values_one_level_off": int((levels > 0).sum()), "share": share,
                           "lq_shape": list(on_card.shape),
                           "stage_buckets": [draws.stage1.bucket, draws.stage2.bucket],
                           "modes": [draws.stage1.mode, draws.stage2.mode]}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def phase_realesrgan(device: str = "cuda"):
    """The RealESRGAN-SSL train and test CLIs at full width on the
    ``realesrgan_fixtures`` data: RE_ITERS iterations (each degrades the GT
    batch on the card, makes the USM target, passes the pool, then trains G,
    D and the EMA with K1 in the SSL loss), the training state reloaded into
    a fresh model bit for bit (pool and generators included),
    ``--auto_resume`` to RE_RESUME_ITERS, then the test CLI on the last
    ``net_g`` over the BlindLR-style set with PSNR/SSIM (LPIPS and DISTS are
    left out of the option file: they raise until ROADMAP queue 1 item 9).
    Then the degradation + USM + pool alone (CUDA events) and the degradation
    hold card against CPU.  K1 must launch once per iteration."""
    import gc
    import tempfile

    import numpy as np
    import torch
    import ssl_tpu_torch.test as test_cli
    import ssl_tpu_torch.train as train_cli
    from ssl_tpu_torch.data import build_dataloader, build_dataset
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.models.realesrganssl_model import RealESRGANSSLModel
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.ops.degrade import degrade_two_stage
    from ssl_tpu_torch.ops.img_process import usm_sharp
    from ssl_tpu_torch.utils import logger as logger_mod

    with tempfile.TemporaryDirectory(prefix="realesrgan_smoke_") as root:
        t0 = time.perf_counter()
        d, edge_share = realesrgan_fixtures(os.path.join(root, "data"), device)
        fixtures_s = time.perf_counter() - t0
        opt = realesrgan_opt(d)
        opt_path = os.path.join(root, "train_realesrgan.json")
        with open(opt_path, "w") as f:
            json.dump(opt, f)
        dev = ["--device", device] if device != "cuda" else []

        def run(args):
            """One train CLI run: its state, logged lines, K1 launches, the
            pool pointer after each step and wall seconds."""
            logged, ptrs = [], []
            log_call = logger_mod.MessageLogger.__call__
            step_call = RealESRGANSSLModel.train_step

            def record(self, log_vars):
                logged.append(dict(log_vars, start=self.start_iter))
                return log_call(self, log_vars)

            def step(self, state, batch, draws=None):
                out = step_call(self, state, batch, draws)
                ptrs.append(state.extra["queue_ptr"])
                return out
            logger_mod.MessageLogger.__call__ = record
            RealESRGANSSLModel.train_step = step
            try:
                ssg_cuda.launches = 0
                t0 = time.perf_counter()
                state = train_cli.train_pipeline(root, ["-opt", opt_path] + dev + args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = ssg_cuda.launches
            finally:
                logger_mod.MessageLogger.__call__ = log_call
                del RealESRGANSSLModel.train_step             # the mixin's again
            gc.collect()                                  # the loader's workers end here
            return state, logged, launches, ptrs, wall

        torch.cuda.reset_peak_memory_stats()
        state, logged, launches, ptrs, wall = run([])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        exp = os.path.join(root, "experiments", opt["name"])
        if launches != RE_ITERS:
            fail(f"realesrgan: K1 launched {launches} times in {RE_ITERS} iterations")
        if [x["iter"] for x in logged] != list(range(1, RE_ITERS + 1)):
            fail(f"realesrgan: logged iterations {[x['iter'] for x in logged]}")
        if ptrs != [min(RE_B * (i + 1), RE_QUEUE) for i in range(RE_ITERS)] or ptrs[1] != RE_QUEUE:
            fail(f"realesrgan: the pool pointer read {ptrs} after iterations 1-{RE_ITERS}")
        loss_keys = ("l_pix", "l_percep", "l_g_gan", "l_selfsim", "l_selfsim_kl", "l_d_real",
                     "l_d_fake")
        for x in logged:
            bad = {k: x.get(k) for k in loss_keys if not np.isfinite(x.get(k, np.nan))}
            if bad:
                fail(f"realesrgan: iteration {x['iter']}: losses missing or not finite: {bad}")
        for f in (f"models/net_g_{RE_ITERS}.pth", f"models/net_d_{RE_ITERS}.pth",
                  f"training_states/{RE_ITERS}.state"):
            if not os.path.isfile(os.path.join(exp, f)):
                fail(f"realesrgan: {f} was not written")

        # the training state, reloaded into a fresh model, bit for bit
        fresh = build_model(dict(opt, is_train=True), device=device)
        reloaded, it = fresh.load_training_state(fresh.init_state(seed=1),
                                                 os.path.join(exp, "training_states"), RE_ITERS)
        n_tensors = 0
        for name in ("net_g", "net_g_ema", "net_d"):
            want = getattr(state, name).state_dict()
            for k, v in getattr(reloaded, name).state_dict().items():
                n_tensors += 1
                if not torch.equal(v, want[k]):
                    fail(f"realesrgan: reloaded {name}.{k} differs from the saved state")
        for name in ("opt_g", "opt_d"):
            want = getattr(state, name).state_dict()["state"]
            for pid, st in getattr(reloaded, name).state_dict()["state"].items():
                for k, v in st.items():
                    n_tensors += 1
                    if not torch.equal(v, want[pid][k]):
                        fail(f"realesrgan: reloaded {name} state {pid}.{k} differs")
        for k, v in state.extra.items():
            got = reloaded.extra[k]
            n_tensors += 1
            same = (torch.equal(got.get_state(), v.get_state())
                    if isinstance(v, torch.Generator) else
                    torch.equal(got, v) if torch.is_tensor(v) else got == v)
            if not same:
                fail(f"realesrgan: reloaded extra[{k!r}] differs from the saved state")
        if it != RE_ITERS or reloaded.step != state.step:
            fail(f"realesrgan: reloaded iteration {it}, step {reloaded.step} vs {state.step}")
        del fresh, reloaded, state
        gc.collect()
        torch.cuda.empty_cache()

        resumed, logged_r, launches_r, ptrs_r, wall_r = run(
            ["--auto_resume", "--force_yml", f"train:total_iter={RE_RESUME_ITERS}"])
        if [x["iter"] for x in logged_r] != list(range(RE_ITERS + 1, RE_RESUME_ITERS + 1)):
            fail(f"realesrgan: the resumed run logged iterations {[x['iter'] for x in logged_r]}")
        if launches_r != RE_RESUME_ITERS - RE_ITERS or resumed.step != RE_RESUME_ITERS or \
                set(ptrs_r) != {RE_QUEUE}:
            fail(f"realesrgan: the resumed run launched K1 {launches_r} times, ended at step "
                 f"{resumed.step}, pool pointer {ptrs_r}")
        del resumed
        gc.collect()
        torch.cuda.empty_cache()

        test_opt = {"name": "test_RealESRGANSSL_x4", "model_type": "RealESRGANSSLModel",
                    "scale": SCALE, "num_devices": 1, "manual_seed": 0, "tile_process": False,
                    "tile_size": 800, "tile_pad": 32,
                    "datasets": {"test_1": {"name": "BlindLR", "type": "MultiLROneGTDataset",
                                            "dataroot_gt": d["test_gt"],
                                            "dataroot_lq": d["test_lq"],
                                            "io_backend": {"type": "disk"}}},
                    "network_g": opt["network_g"],
                    "path": {"pretrain_network_g": os.path.join(
                        exp, "models", f"net_g_{RE_RESUME_ITERS}.pth"),
                        "param_key_g": "params_ema"},
                    "val": {"save_img": True, "metrics": CLI_METRICS}}
        test_path = os.path.join(root, "test_realesrgan.json")
        with open(test_path, "w") as f:
            json.dump(test_opt, f)
        t0 = time.perf_counter()
        test_out = test_cli.test_pipeline(root, ["-opt", test_path] + dev)["BlindLR"]
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        if set(test_out) != set(CLI_METRICS) or not all(np.isfinite(v) for v in test_out.values()):
            fail(f"realesrgan: test CLI metrics {test_out}")

        # the degradation, USM and pool alone, on one loader batch
        dopt = dict(opt["datasets"]["train"], phase="train", scale=SCALE, num_worker_per_gpu=0)
        batch = next(iter(build_dataloader(build_dataset(dopt), dopt)))
        batch = {k: v.to(device) for k, v in batch.items() if torch.is_tensor(v)}
        model = build_model(dict(opt, is_train=True), device=device)
        state = model.init_state(seed=0)
        state.net_g = state.net_g_ema = state.net_d = None    # only extra is used here
        torch.cuda.empty_cache()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        front_ms = []
        for _ in range(RE_QUEUE // RE_B + 3):                 # fill, then full
            torch.cuda.synchronize()
            e0.record()
            model.degrade_batch(state, batch)
            e1.record()
            torch.cuda.synchronize()
            front_ms.append(e0.elapsed_time(e1))
        draws = model.draws(state, batch)["degrade"]
        degrade_ms = time_ms(lambda: degrade_two_stage(batch["gt"], batch["kernel1"],
                                                       batch["kernel2"], batch["sinc_kernel"],
                                                       model.degrade_cfg, draws), 5)
        usm_ms = time_ms(lambda: usm_sharp(batch["gt"]), 5)
        hold = degradation_hold(batch, model.degrade_cfg)
        del model, state, batch
        torch.cuda.empty_cache()

    fill = RE_QUEUE // RE_B
    result = {
        "phase": "realesrgan", "model": "RealESRGANSSLModel", "config":
            "options/train/RealESRGANSSL/train_RealESRGANSSL_x4.yml",
        "train_images": RE_TRAIN, "gt_image": RE_GT_IMG, "crop_pre": RE_CROP, "batch": RE_B,
        "lq_size": RE_CROP // SCALE, "workers": RE_WORKERS, "fixtures_s": fixtures_s,
        "mask_edge_share": edge_share, "decoder": decoder(),
        "reduced": {"queue_size": [180, RE_QUEUE], "dataset_enlarge_ratio": [1, RE_ENLARGE],
                    "total_iter": [150000, RE_RESUME_ITERS],
                    "test_metrics_left_out": ["lpips", "dists"],
                    "test_sets": ["7 sets of options/test/RealESRGANSSL", "BlindLR of "
                                  f"{RE_TEST_GT} GT x {len(RE_VARIANTS)} variants"]},
        "iterations": RE_ITERS, "iterations_timed": RE_ITERS - 1,
        "ms_per_iter": per_iter_ms(logged, "time"),
        "data_wait_ms_per_iter": per_iter_ms(logged, "data_time"),
        "first_iter_ms": 1e3 * logged[0]["time"], "first_data_wait_ms": 1e3 * logged[0]["data_time"],
        "resumed_ms_per_iter": per_iter_ms(logged_r, "time"),
        "resumed_data_wait_ms_per_iter": per_iter_ms(logged_r, "data_time"),
        "wall_s": wall, "resumed_wall_s": wall_r, "peak_mem_gb": peak_gb,
        "k1_launches": {"train": launches, "resumed": launches_r},
        "pool_ptr_by_iter": ptrs + ptrs_r,
        "losses_last_iter": {k: logged[-1][k] for k in loss_keys},
        "reloaded_tensors_bit_for_bit": n_tensors, "resumed_from": RE_ITERS,
        "test": dict(test_out, seconds=test_s),
        "degradation_usm_pool_ms": {"fill": front_ms[:fill], "full": front_ms[fill:]},
        "degradation_alone_ms": degrade_ms, "usm_alone_ms": usm_ms,
        "degradation_hold_card_vs_cpu": hold,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32, "card": card()}
    emit(result)
    return launches + launches_r


def kernels_line(k1, k2, k2_bwd, serve, train, launches, cli, realesrgan) -> dict:
    """The {"kernels": [...]} line: one entry per kernel of the port, from the
    phases' results (K1's, K2's forward's and backward's by case, the serving
    K2 launches and forward kernel launches, the diffusion_train launch
    counts, and the K1 launches of the ESRGAN train step and of the CLIs)."""
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

    k1_runs = {"main_path": launches + cli, "diffusion_smooth": train["k1"],
               "realesrgan_edges": realesrgan}

    def k1_mean(key):
        return sum(w * k1[c][key] for c, w in k1_runs.items()) / sum(k1_runs.values())

    return {"kernels": [{
        "name": "ssg_loss_fwd", "route": "cuda", "source": "ssl_tpu_torch/csrc/ssg_loss_fwd.cu",
        "replaces": "ssl_tpu/ops/ssg_pallas.py:41",
        "launches": launches + cli + train["k1"] + realesrgan,
        "launches_by_path": {"esrgan_train": launches, "esrgan_cli": cli,
                             "diffusion_train": train["k1"], "realesrgan_cli": realesrgan},
        "max_abs_err": max(k1[c]["max_abs_err"] for c in ("main_smooth", "diffusion_smooth",
                                                          "realesrgan_edges")),
        "ms": k1_mean("device_ms"), "wrapper_ms": k1_mean("ms"), "plain_ms": k1_mean("plain_ms"),
        "bound_ms": k1_mean("bound_ms"), "bound_by": k1["main_path"]["bound_by"],
        "library_ms": None,
        "ms_by_shape": {"b16_3x128^2": k1["main_path"]["device_ms"],
                        "b2_3x512^2": k1["diffusion_smooth"]["device_ms"],
                        "b12_3x400^2": k1["realesrgan_edges"]["device_ms"]},
        "bound_ms_by_shape": {"b16_3x128^2": k1["main_path"]["bound_ms"],
                              "b2_3x512^2": k1["diffusion_smooth"]["bound_ms"],
                              "b12_3x400^2": k1["realesrgan_edges"]["bound_ms"]},
        "times_are": "mean per launch over the run's launches (b16 3x128^2 in the ESRGAN "
                     "step and CLI, b2 3x512^2 in the diffusion mini-step, b12 3x400^2 in the "
                     "RealESRGAN-SSL CLI); ms is the kernel's device time (profiler), wrapper_ms "
                     "the call's (CUDA events); max_abs_err on smooth images and, at b12 "
                     "3x400^2, on pictures with real edge masks"},
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
    torch.cuda.empty_cache()
    cli = phase_cli()
    torch.cuda.empty_cache()
    realesrgan = phase_realesrgan()

    emit(kernels_line(k1, k2, k2_bwd, serve, train, launches, cli, realesrgan))
    print(card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
