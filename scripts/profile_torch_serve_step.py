"""Where the time of the port's diffusion serving goes, on one CUDA device.

    python3 scripts/profile_torch_serve_step.py [--iters 5] [--rounds 4]

Builds chip_smoke.py's serving model (options/diffusion/ssl_base.yml at full
width, use_flash_attention on, random weights with the zero-initialised
layers drawn from a seeded normal) and prints JSON lines at 512^2 (a 64^2
latent), with the serving defaults for TF32 (cuDNN on, matmul off):

* "steps": CUDA-event times of one denoising step (struct-cond encoder +
  UNet) through the K2 route and through the plain route (every flash
  switch off), ``--rounds`` rounds in turns K2, plain, plain, K2, ...; the
  step is bound by the host, whose time moves by a few ms between runs, so
  only the spread over the rounds says whether the routes differ;
* "parts": each network alone and VAE encode and decode on each route, and
  the peak device memory of one step on each route;
* "host": the host's time per attention call at the UNet's ds-2 shape
  (1, 8, 1024, 1024, 64), without waiting for the device, on each route;
* "profile": torch.profiler over ``--iters`` denoising steps on each route:
  device busy time per step, its share of the unprofiled step time, kernel
  launches per step, K2's device time, and on the K2 route the top kernels.
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
    from chip_smoke import SERVE_SIZE, card, flash_modules, phase_diffusion

    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    model, state = phase_diffusion()
    p, vae = model.infer_params(state), state.frozen["vae"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    side = SERVE_SIZE // 8
    img = torch.rand((1, 3, SERVE_SIZE, SERVE_SIZE), generator=gen, device="cuda") * 2 - 1
    z = torch.randn((1, 4, side, side), generator=gen, device="cuda")
    t = torch.full((1,), 500, device="cuda")
    ctx = p["null_context"][None]

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

    def step():
        model.apply_model(p, z, t, ctx, z)

    def set_route(route):
        for m in flash_modules(state):
            m.use_flash_attention = route == "k2"

    parts = {"structcond": lambda: p["structcond"](z, t),
             "unet": lambda: p["unet"](z, t, ctx, p["structcond"](z, t)),
             "vae_encode": lambda: vae.encode(img),
             "vae_decode": lambda: vae.decode(z)}
    steps = {"k2": [], "plain": []}
    part_ms, peak_gb, profiles = {}, {}, {}
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        for r in range(args.rounds):
            for route in (("k2", "plain") if r % 2 == 0 else ("plain", "k2")):
                set_route(route)
                steps[route].append(timed(step, 2 * args.iters))
        for route in ("k2", "plain"):
            set_route(route)
            part_ms[route] = {name: timed(fn) for name, fn in parts.items()}
            part_ms[route]["unet"] -= part_ms[route]["structcond"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step()
            torch.cuda.synchronize()
            peak_gb[route] = torch.cuda.max_memory_allocated() / 1e9
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(args.iters):
                    step()
                torch.cuda.synchronize()
            profiles[route] = prof
    print(json.dumps({"steps_ms": steps, "size": SERVE_SIZE,
                      "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                      "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}), flush=True)
    print(json.dumps({"parts_ms": part_ms, "step_peak_mem_gb": peak_gb}), flush=True)

    from ssl_tpu_torch.ops.attention import sdp_attention
    q, k, v = (torch.randn((1, 1024, 8, 64), generator=gen, device="cuda") for _ in range(3))
    host_us = {}
    with torch.no_grad():
        for route in ("k2", "plain"):
            sdp_attention(q, k, v, 0.125, route == "k2")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                sdp_attention(q, k, v, 0.125, route == "k2")
            host_us[route] = 1e4 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
    print(json.dumps({"host_us_per_attention_call": host_us}), flush=True)

    # device time from the kernels' own events (one stream, so their sum is
    # busy time), against the unprofiled step time measured above
    for route, prof in profiles.items():
        kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                          for e in prof.key_averages() if e.device_type.name == "CUDA"
                          and not getattr(e, "is_user_annotation", False)),
                         key=lambda k: -k[1])
        step_ms = sum(steps[route]) / len(steps[route])
        busy_ms = sum(ms for _, ms, _ in kernels) / args.iters
        k2_ms = sum(ms for name, ms, _ in kernels if "flash_attn_fwd" in name) / args.iters
        out = {"route": route, "step_ms": step_ms, "device_busy_ms_per_step": busy_ms,
               "device_busy_share": busy_ms / step_ms, "k2_ms_per_step": k2_ms,
               "launches_per_step": sum(c for _, _, c in kernels) / args.iters,
               "n_kernel_kinds": len(kernels)}
        if route == "k2":
            out["top"] = [{"name": name[:90], "ms_per_step": ms / args.iters,
                           "calls_per_step": c / args.iters} for name, ms, c in kernels[:15]]
        print(json.dumps({"profile": out}), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
