"""Time ``simself_strategy`` losses forward and backward on the card.

    python -m ssl_tpu_torch.scripts.time_strategy \\
        --strategy areaarea_mask_nonlocal areaarea_mask_nonlocal_cuda_v1 \\
        --batch 2 --size 512 --mask_stride 3 --capacity 2048 --density 0.28 [--iters 3]

Seeded smooth pictures (GT, and SR as GT plus noise) with a random edge mask
of the given density go through ``ssl_loss`` in float32 with each strategy,
at the zoo's options (search 25, window 9, tiles 16, softmax on SR only).
For each strategy one JSON line: ms forward + backward (CUDA events over
``--iters`` calls after a first one), peak memory, and the edge pixels per
image after the mask stride against the capacity.  TF32 is off.
``--capacity 0`` takes the largest edge count of the batch, so no edge pixel
is dropped."""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from ssl_tpu_torch.losses.ssl_loss import SSLSetting, ssl_loss
from ssl_tpu_torch.ops.ssg import apply_mask_stride


def inputs(batch: int, size: int, density: float, seed: int, device: str):
    """(sr, gt, mask): GT a bilinear upsampling of 16 x 16 noise, SR GT plus
    noise of 0.05, the mask 1 at a ``density`` share of pixels."""
    g = torch.Generator(device=device).manual_seed(seed)
    gt = torch.rand(batch, 3, 16, 16, device=device, generator=g)
    gt = F.interpolate(gt, size=(size, size), mode="bilinear", align_corners=False)
    sr = (gt + 0.05 * torch.randn(gt.shape, device=device, generator=g)).clamp(0, 1)
    mask = (torch.rand(batch, 1, size, size, device=device, generator=g) < density).float()
    return sr, gt, mask


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--strategy", nargs="+", required=True)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--mask_stride", type=int, default=3)
    ap.add_argument("--capacity", type=int, default=2048)
    ap.add_argument("--density", type=float, default=0.28)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    sr, gt, mask = inputs(args.batch, args.size, args.density, args.seed, "cuda")
    edges = apply_mask_stride(mask[:, 0], args.mask_stride).reshape(args.batch, -1).sum(1)
    edges = [int(e) for e in edges]
    capacity = args.capacity or max(edges)
    opts = tuple(sorted(dict(simself_dh=16, simself_dw=16, kernel_size=25, kernel_size_center=9,
                             scaling_factor=1.0, softmax_sr=True, softmax_gt=False).items()))
    x = sr.clone().requires_grad_(True)
    for name in args.strategy:
        setting = SSLSetting(strategy=name, strategy_opts=opts, mask_stride=args.mask_stride,
                             capacity=capacity, l1_weight=0.5, kl_weight=0.5)

        def call():
            x.grad = None
            l1, kl = ssl_loss(x, gt, mask, setting)
            (l1 + kl).backward()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(call, args.iters)
        print(json.dumps({"strategy": name, "batch": args.batch, "size": args.size,
                          "mask_stride": args.mask_stride, "capacity": capacity,
                          "edges_per_image": edges, "ms_fwd_bwd": ms,
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "card": card()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
