"""Where the time of the port's ESRGAN-SSL or RealESRGAN-SSL train step goes,
on one CUDA device.

    python3 scripts/profile_torch_train_step.py [--recipe esrgan|bench|realesrgan]
        [--dtype bf16|fp32] [--batch 16] [--iters 3]

``esrgan`` runs the step of chip_smoke.py's train phase (the shipped
ESRGAN-SSL widths, random weights, bench-like random batch); ``bench`` the
step of bench.py:54-116 (chip_smoke.bench_opt: batch 24 by default,
UNetDiscriminatorSN, with ``--dtype bf16`` its bf16 defaults for G, D and
the SSG, with ``fp32`` those four knobs in float32); ``realesrgan``
the step of its realesrgan phase (the shipped RealESRGAN-SSL widths, batch 12
by default, GT 400^2 pictures made on the card with their edge masks and
kernels from the port's synthesis, the pool cut to 24 slots and full).
Prints JSON lines:

* "components": CUDA-event times of the step's parts run alone on the same
  inputs: (RealESRGAN) the degradation + USM + pool, G forward+backward, the
  SSL loss forward (K1) and backward (plain PyTorch), the perceptual loss
  forward+backward, the G-phase D calls, the D phase, and the optimizer +
  EMA updates;
* "profile": torch.profiler over ``--iters`` steps: the top kernels by device
  time, kernel launches per step, and the device's busy share of the
  unprofiled step time.
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
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (BENCH_B, BENCH_GT, MAIN_GT, RE_B, RE_CROP, RE_QUEUE, SCALE,
                            bench_opt, card, realesrgan_opt, shipped_opt, smooth_picture)
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.models.srgan_model import frozen_discriminator

    ap = argparse.ArgumentParser()
    ap.add_argument("--recipe", choices=("esrgan", "bench", "realesrgan"), default="esrgan")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16",
                    help="the bench recipe's bf16 knobs: bench.py's defaults or float32")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    rng = np.random.RandomState(0)
    if args.recipe in ("esrgan", "bench"):
        if args.recipe == "esrgan":
            b, gt_size = args.batch or 16, MAIN_GT
            model = build_model(shipped_opt(b))
        else:
            b, gt_size = args.batch or BENCH_B, BENCH_GT
            model = build_model(bench_opt({"bf16": "bfloat16", "fp32": "float32"}[args.dtype]))
        state = model.init_state(seed=0)
        lq_size = gt_size // SCALE
        batch = {k: torch.from_numpy(v).cuda() for k, v in {
            "lq": rng.rand(b, 3, lq_size, lq_size).astype(np.float32),
            "gt": rng.rand(b, 3, gt_size, gt_size).astype(np.float32),
            "gt_mask": (rng.rand(b, 1, gt_size, gt_size) < 0.25).astype(np.float32)}.items()}
        raw = batch
    else:
        import random
        from ssl_tpu_torch.data.realesrgan_dataset import _KernelSynth
        from ssl_tpu_torch.ops.edge_mask import edge_mask_torch
        b = args.batch or RE_B
        opt = realesrgan_opt({"gt": None, "mask": None})
        opt["queue_size"] = RE_QUEUE * b // RE_B
        model = build_model(opt)
        state = model.init_state(seed=0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        gt = torch.stack([smooth_picture(RE_CROP, RE_CROP, gen, "cuda") for _ in range(b)]) / 255
        random.seed(0)
        np.random.seed(0)
        synth = _KernelSynth(opt["datasets"]["train"])
        kernels = [synth.sample() for _ in range(b)]
        raw = {"gt": gt, "gt_mask": edge_mask_torch(gt, 20.0),
               **{k: torch.from_numpy(np.stack([ks[i] for ks in kernels])).cuda()
                  for i, k in enumerate(("kernel1", "kernel2", "sinc_kernel"))}}
        while state.extra.get("queue_ptr", 0) < model.queue_size:     # fill the pool
            model.degrade_batch(state, raw)
        batch = model.degrade_batch(state, raw)

    def timed(fn, iters=args.iters):
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters

    from ssl_tpu_torch.losses.ssl_loss import ssl_loss
    net_g, net_d = state.net_g, state.net_d
    sr_fixed = net_g(batch["lq"]).detach()

    def g_fwd_bwd():
        net_g(batch["lq"]).mean().backward()

    def ssl_fwd():
        with torch.no_grad():
            ssl_loss(sr_fixed, batch["gt"], batch["gt_mask"], model.ssl_setting)

    def ssl_fwd_bwd():
        s = sr_fixed.clone().requires_grad_(True)
        l1, kl = ssl_loss(s, batch["gt"], batch["gt_mask"], model.ssl_setting)
        (l1 + kl).backward()

    def percep_fwd_bwd():
        s = sr_fixed.clone().requires_grad_(True)
        p, st = model.cri_perceptual(s, batch["gt"])
        (p + st).backward()

    def g_phase_d():
        s = sr_fixed.clone().requires_grad_(True)
        with frozen_discriminator(net_d):
            fake, real = net_d(s), net_d(batch["gt"])
        model.gan_g_loss(fake, real.detach()).backward()

    def d_phase():
        loss, _ = model.d_losses(state, batch, sr_fixed)
        loss.backward()

    def updates():
        from ssl_tpu_torch.models.base_model import ema_update, optimizer_step
        optimizer_step(state.opt_g, 1e-4)
        optimizer_step(state.opt_d, 1e-4)
        ema_update(state.net_g_ema, net_g, 0.999)

    comps = {} if args.recipe != "realesrgan" else {
        "degrade_usm_pool": timed(lambda: model.degrade_batch(state, raw))}
    comps |= {"g_fwd_bwd": timed(g_fwd_bwd), "ssl_fwd_k1": timed(ssl_fwd),
             "ssl_fwd_bwd": timed(ssl_fwd_bwd), "percep_fwd_bwd": timed(percep_fwd_bwd),
             "g_phase_d_fwd_bwd": timed(g_phase_d), "d_phase_fwd_bwd": timed(d_phase),
             "optim_ema": timed(updates)}
    comps["ssl_bwd_plain"] = comps["ssl_fwd_bwd"] - comps["ssl_fwd_k1"]
    comps["train_step"] = timed(lambda: model.train_step(state, raw))
    print(json.dumps({"recipe": args.recipe, "dtype": args.dtype if args.recipe == "bench"
                      else "fp32", "components_ms": comps, "batch": b,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            model.train_step(state, raw)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device time: the kernels' own events (an op's self device time would
    # count its kernels a second time, and a user annotation such as
    # Optimizer.step spans kernels on the device timeline); one stream, so
    # their sum is busy time.  The profiler slows the host, so the busy share
    # is taken against the unprofiled step time above.
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages() if e.device_type.name == "CUDA"
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda t: -t[1])
    busy_ms = sum(t for _, t, _ in kernels) / args.iters
    top = [{"name": k[:90], "ms_per_step": t / args.iters, "calls_per_step": c / args.iters}
           for k, t, c in kernels[:15]]
    print(json.dumps({"profile": {
        "profiled_wall_ms_per_step": wall_ms / args.iters,
        "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms / comps["train_step"],
        "launches_per_step": sum(c for _, _, c in kernels) / args.iters,
        "n_kernel_kinds": len(kernels), "top": top}}), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
