"""Where the time of the port's ESRGAN-SSL train step goes, on one CUDA device.

    python3 scripts/profile_torch_train_step.py [--batch 16] [--iters 3]

Runs the step of chip_smoke.py's train phase (the shipped ESRGAN-SSL widths,
random weights, bench-like random batch) and prints JSON lines:

* "components": CUDA-event times of the step's parts run alone on the same
  inputs: G forward+backward, the SSL loss forward (K1) and backward (plain
  PyTorch), the perceptual loss forward+backward, the G-phase D calls, the D
  phase, and the optimizer + EMA updates;
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
    from chip_smoke import MAIN_GT, SCALE, card, shipped_opt
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.models.srgan_model import frozen_discriminator

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    b = args.batch
    model = build_model(shipped_opt(b))
    state = model.init_state(seed=0)
    rng = np.random.RandomState(0)
    lq_size = MAIN_GT // SCALE
    batch = {k: torch.from_numpy(v).cuda() for k, v in {
        "lq": rng.rand(b, 3, lq_size, lq_size).astype(np.float32),
        "gt": rng.rand(b, 3, MAIN_GT, MAIN_GT).astype(np.float32),
        "gt_mask": (rng.rand(b, 1, MAIN_GT, MAIN_GT) < 0.25).astype(np.float32)}.items()}

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

    comps = {"g_fwd_bwd": timed(g_fwd_bwd), "ssl_fwd_k1": timed(ssl_fwd),
             "ssl_fwd_bwd": timed(ssl_fwd_bwd), "percep_fwd_bwd": timed(percep_fwd_bwd),
             "g_phase_d_fwd_bwd": timed(g_phase_d), "d_phase_fwd_bwd": timed(d_phase),
             "optim_ema": timed(updates)}
    comps["ssl_bwd_plain"] = comps["ssl_fwd_bwd"] - comps["ssl_fwd_k1"]
    comps["train_step"] = timed(lambda: model.train_step(state, batch))
    print(json.dumps({"components_ms": comps, "batch": b}), flush=True)

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            model.train_step(state, batch)
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
