"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; the first failure exits non-zero:

1. build   compile the port's CUDA kernel (K1) with nvcc
2. kernel  hold K1 (ssl_tpu_torch/csrc/ssg_loss_fwd.cu) against its plain
           PyTorch version on the card: a small case (search 9, window 5),
           the shipped search 25 / window 9 / sigma 0.004 on smooth images
           at 32^2 and at the main path's shape (b16, 3x128^2), and the main
           path's own inputs (bench.py's uniform images, on which every
           off-centre q is 0); forward outputs and d_sr through the autograd
           function, with the L1 subgradient's ties accounted for; times the
           kernel, the plain forward and the backward
3. train   the ESRGAN-SSL train step at the shipped widths (RRDBNet 64/23/32,
           VGGStyleDiscriminator 64, VGG19 conv5_4, SSL 25/9/0.004), batch 16,
           gt 128: one warm-up step and 3 timed steps through build_model ->
           init_state -> train_step, with the kernel launch counts read
           around them
4. kernels one line per ported kernel: launches on the main path, error
           against the plain version, times and the bound

then the card's name and power limit as nvidia-smi reports them, and last
{"ok": true, "device": {...}}.  Weights are random from fixed seeds (no
VGG19 weight file is in the repository).  Needs one CUDA device; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): the bound of a kernel is
# the larger of its bytes over the memory rate and its fp32 operations over
# the fp32 (non-tensor-core) rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

MAIN_B, MAIN_GT, SCALE = 16, 128, 4

# |x - y| / max(x, y) below which the plain forward's sign(x - y) counts as
# tied: q carries up to ~1e-5 of relative rounding at sigma 0.004 and the
# kernel's inverse maps ~2e-5, so another summation order moves x - y by less.
TIE_RTOL = 1e-4
# Largest relative L2 error of d_sr with the full mask, where tied signs that
# flip move g_d by 2 g_l1 at their pixel-offsets (2.05e-5 on an H100 at b16,
# 3x128^2, search 25, window 9, sigma 0.004 on smooth images: PERF.md).
D_SR_REL_L2 = 1e-3


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
    from ssl_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    _, log = cuda_build.build("ssg_loss_fwd")
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels": ["ssg_loss_fwd"],
          "ptxas": regs})


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
    """K1 against its plain version (``hold_k1``), then its times."""
    import torch
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.ops.ssg import SSGConfig, ssl_loss_dense_bwd, ssl_loss_sums_reference

    shipped = SSGConfig(search=25, window=9, sigma=0.004)
    cases = [("small", smooth_case(2, 20, 47, 0.3), SSGConfig(search=9, window=5, sigma=0.1),
              1e-5),
             ("shipped_32", smooth_case(1, 32, 2, 0.3), shipped, 1e-4),
             ("main_smooth", smooth_case(MAIN_B, MAIN_GT, 3, 0.25), shipped, 1e-4),
             ("main_path", bench_case(MAIN_B, MAIN_GT, 0, 0.25), shipped, 1e-5)]
    results = {}
    for name, arrays, cfg, map_rtol in cases:
        sr, gt, mask = (torch.from_numpy(a).cuda() for a in arrays)
        errs, ties = hold_k1(name, sr, gt, mask, cfg, map_rtol, ssg_cuda.ssg_loss_fwd_cuda)
        one = torch.ones((), device="cuda")
        iters = 20 if sr.shape[0] == MAIN_B else 50
        kernel_ms = time_ms(lambda: ssg_cuda.ssg_loss_fwd_cuda(sr, gt, mask, cfg), iters)
        plain_ms = time_ms(lambda: ssl_loss_sums_reference(sr, gt, mask, cfg), 2)
        maps = ssg_cuda.ssg_loss_fwd_cuda(sr, gt, mask, cfg)
        bwd_ms = time_ms(lambda: ssl_loss_dense_bwd(sr, gt, mask, maps[3], maps[4], one, one,
                                                    cfg, maps[5], maps[6]), 2)
        b, c, h, w = sr.shape
        nbytes = 4 * (2 * b * c * h * w + b * h * w) + 4 * (4 * b * h * w + 3)
        ops = k1_operations(b, c, h, w, cfg.search, cfg.generalization)
        bound_ms = 1e3 * max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S)
        results[name] = {"max_abs_err": max(errs.values()), "ms": kernel_ms,
                         "plain_ms": plain_ms, "bwd_ms": bwd_ms, "bound_ms": bound_ms,
                         "bound_by": "bytes" if nbytes / PEAK_BYTES_PER_S
                         > ops / PEAK_FP32_PER_S else "operations"}
        emit({"phase": "kernel", "kernel": "ssg_loss_fwd", "case": name,
              "shape": [b, c, h, w], "search": cfg.search, "window": cfg.window,
              "sigma": cfg.sigma, "max_abs_err": errs, "ties": ties, "kernel_ms": kernel_ms,
              "plain_ms": plain_ms, "bwd_ms": bwd_ms, "bytes": nbytes, "operations": ops,
              "bound_ms": bound_ms, "launches_so_far": ssg_cuda.launches})
    # times and bound at the train step's own inputs; the error where they are
    # not degenerate (bench.py's uniform images make every off-centre q 0)
    return dict(results["main_path"], max_abs_err=results["main_smooth"]["max_abs_err"])


def phase_train():
    import numpy as np
    import torch
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.ops import ssg_cuda

    model = build_model(shipped_opt(MAIN_B))
    state = model.init_state(seed=0)
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

    phase_build()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k1 = phase_kernel()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    launches = phase_train()
    emit({"kernels": [{
        "name": "ssg_loss_fwd", "route": "cuda", "source": "ssl_tpu_torch/csrc/ssg_loss_fwd.cu",
        "replaces": "ssl_tpu/ops/ssg_pallas.py:41", "launches": launches,
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None}]})
    print(card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
