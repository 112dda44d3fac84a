"""Where the time of the port's diffusion training mini-step goes, on one CUDA device.

    python3 scripts/profile_torch_diffusion_train_step.py [--iters 3] [--rounds 3]

Builds chip_smoke.py's diffusion model (options/diffusion/ssl_base.yml at
full width with its training options, use_flash_attention on, random
weights with the zero-initialised layers drawn from a seeded normal) and
prints JSON lines for mini-steps at 512^2, batch 2 (chip_smoke.py's smooth
synthetic GT/LQ and mask of density 0.25), with the default TF32 settings
(cuDNN on, matmul off):

* "steps": host-clock times of a non-applying mini-step (what 11 of every
  12 are) through the K2 route and through the plain route (every flash
  switch off), ``--rounds`` rounds in turns K2, plain, plain, K2, ...,
  and each route's peak device memory;
* "parts": the pieces of a mini-step on the K2 route, each alone, on the
  step's own shapes: the no-grad VAE encode of [gt; lq], the struct-cond
  encoder and UNet forward and backward through l_simple, the remat'd
  decode of x0 with its backward, the SSL loss forward (K1) and its plain
  backward, AdamW's update and the EMA update;
* "profile": torch.profiler over one non-applying mini-step on the K2
  route: device busy time, its share of the unprofiled mini-step, kernel
  launches, K2's forward and backward device time, and the top kernels.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (TRAIN_SIZE, card, flash_modules, phase_diffusion, reset_training,
                            train_batch)
    from ssl_tpu_torch.diffusion.ddpm_ssl import trainable
    from ssl_tpu_torch.losses.ssl_loss import ssl_loss

    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    model, state = phase_diffusion()
    vae, params = state.frozen["vae"], state.params
    batch = train_batch(TRAIN_SIZE, seed=30)
    draws = model.draws(state, batch["gt"])

    def timed(fn, iters=args.iters):
        """Mean host-clock ms of ``fn`` after one warm-up, synchronised."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / iters

    def mini_step():
        reset_training(state)          # a non-applying mini-step every time
        model.train_step(state, batch, draws)

    def set_route(route):
        for m in flash_modules(state):
            m.use_flash_attention = route == "k2"

    steps, peak_gb = {"k2": [], "plain": []}, {}
    for r in range(args.rounds):
        for route in (("k2", "plain") if r % 2 == 0 else ("plain", "k2")):
            set_route(route)
            steps[route].append(timed(mini_step, 1))
    for route in ("k2", "plain"):
        set_route(route)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mini_step()
        torch.cuda.synchronize()
        peak_gb[route] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"steps_ms": steps, "peak_mem_gb": peak_gb, "size": TRAIN_SIZE,
                      "batch": batch["gt"].shape[0],
                      "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                      "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}), flush=True)

    set_route("k2")
    b = batch["gt"].shape[0]
    with torch.no_grad():
        imgs = torch.cat([batch["gt"], batch["lq"]]) * 2.0 - 1.0
        z0, z_lq = model.encode(vae, imgs, noise=draws["enc_noise"]).chunk(2)
    ctx = params["null_context"].expand(b, *params["null_context"].shape)
    img01 = batch["lq"]                # a smooth image in [0, 1], as the decoded x0 is

    def encode():
        with torch.no_grad():
            model.encode(vae, imgs, noise=draws["enc_noise"])

    def denoiser():
        out = model.apply_model(params, z0, draws["t"], ctx, z_lq)
        torch.mean((out - draws["noise"]) ** 2).backward()

    def decode():
        z = z0.detach().requires_grad_(True)
        model.decode(vae, z).mean().backward()

    def ssl_fwd():
        with torch.no_grad():
            ssl_loss(img01, batch["gt"], batch["gt_mask"], model.ssl_setting)

    def ssl_fwd_bwd():
        x = img01.detach().requires_grad_(True)
        sum(ssl_loss(x, batch["gt"], batch["gt_mask"], model.ssl_setting)).backward()

    def ema():
        ema_p = trainable(state.ema_params)
        torch._foreach_mul_(ema_p, 0.9999)
        torch._foreach_add_(ema_p, trainable(params), alpha=1e-4)

    parts = {"vae_encode_nograd": timed(encode), "unet_structcond_fwd_bwd": timed(denoiser),
             "vae_decode_remat_fwd_bwd": timed(decode), "ssl_fwd_k1": timed(ssl_fwd),
             "ssl_fwd_bwd": timed(ssl_fwd_bwd), "ema": timed(ema)}
    saved = [p.detach().clone() for p in trainable(params)]
    parts["adamw_update"] = timed(state.opt.step)
    with torch.no_grad():
        for p, s in zip(trainable(params), saved):
            p.copy_(s)
    reset_training(state)
    print(json.dumps({"parts_ms": parts}), flush=True)

    from torch.profiler import ProfilerActivity, profile
    mini_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mini_step()
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages() if e.device_type.name == "CUDA"
                      and not getattr(e, "is_user_annotation", False)), key=lambda k: -k[1])
    step_ms = sum(steps["k2"]) / len(steps["k2"])
    busy_ms = sum(ms for _, ms, _ in kernels)

    def kernel_ms(part):
        return sum(ms for name, ms, _ in kernels if part in name)

    print(json.dumps({"profile": {
        "route": "k2", "step_ms": step_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / step_ms, "launches": sum(c for _, _, c in kernels),
        "k2_fwd_ms": kernel_ms("flash_attn_fwd"), "k2_bwd_dkv_ms": kernel_ms("flash_attn_bwd_dkv"),
        "k2_bwd_dq_ms": kernel_ms("flash_attn_bwd_dq"), "k1_ms": kernel_ms("ssg_loss_fwd"),
        "top": [{"name": name[:90], "ms": ms, "calls": c} for name, ms, c in kernels[:15]]}}),
        flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
