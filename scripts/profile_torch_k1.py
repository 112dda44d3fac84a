"""K1 (the fused SSL-loss forward) at the main paths' shapes, on one CUDA device.

    python3 scripts/profile_torch_k1.py [--root DIR] [--label NAME] [--iters 10]
        [--modes float32,stream,store,both] [--shapes esrgan_train,...]
        [--save DIR [--against LABEL]]

At each training path's shape (``SHAPES``: the ESRGAN step's (16, 3, 128,
128), the diffusion mini-step's (2, 3, 512, 512), RealESRGAN-SSL's
(12, 3, 400, 400) and its host mode's (12, 3, 256, 256), the three KAIR
recipes' and bench.py's (24, 3, 128, 128)), at search 25 / window 9 /
sigma 0.004 on chip_smoke.py's smooth images with a mask of density 0.25,
and in each of K1's modes (``--modes``: ``float32``; ``stream``, ``store``
and ``both`` for the bf16 stream, the bf16 q store and both), prints one JSON
line: the kernels' device time (torch.profiler, ms per call; with the bf16
q store the walk and the stream, each in ``per_kernel_ms``), the wrapper's
time by CUDA events (the reflect padding, the kernels and the sum of the
per-block partials), the call's peak device memory above its inputs (with
the bf16 store: the q stack), the bound (chip_smoke.py::k1_operations at the
fp32 rate), the largest relative error of l1, kl and the inverse maps against
the plain version, and whether a second launch repeats the first bit for
bit.  ``--root`` imports ``ssl_tpu_torch`` from another checkout (for
example an earlier commit unpacked with ``git archive``), so that two
versions are timed in turns on one card.  ``--save DIR`` writes each case's
seven outputs to ``DIR/<label>-<shape>-<mode>.pt``; with ``--against
LABEL`` each case is also compared, bit for bit, with the outputs that a
run labelled LABEL saved there.  Needs a CUDA device; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"esrgan_train": (16, 128), "diffusion_train": (2, 512),
          "realesrgan_train": (12, 400), "realesrgan_host": (12, 256),
          "bsrgan_train": (48, 256), "elan_bsrgan_train": (64, 192),
          "swinir_bsrgan_train": (16, 256), "bench": (24, 128)}
MODES = {"float32": ("float32", "float32"), "stream": ("float32", "bfloat16"),
         "store": ("bfloat16", "float32"), "both": ("bfloat16", "bfloat16")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT, help="checkout whose ssl_tpu_torch is timed")
    ap.add_argument("--label", default="change")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--no-check", action="store_true", help="skip the plain version")
    ap.add_argument("--modes", default="float32", help="comma-separated keys of MODES")
    ap.add_argument("--shapes", default=",".join(SHAPES), help="comma-separated keys of SHAPES")
    ap.add_argument("--save", default=None, help="directory for each case's outputs")
    ap.add_argument("--against", default=None,
                    help="label of an earlier run whose saved outputs each case must equal")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (PEAK_BYTES_PER_S, PEAK_FP32_PER_S, card, k1_operations,
                            kernel_device_ms, smooth_case, time_ms)
    sys.path.insert(0, os.path.abspath(args.root))      # this checkout's ssl_tpu_torch
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.ops.ssg import SSGConfig, ssl_loss_sums_reference
    if not ssg_cuda.__file__.startswith(os.path.abspath(args.root)):
        print(f"ssl_tpu_torch came from {ssg_cuda.__file__}, not {args.root}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    runs = [(shape, mode) for shape in args.shapes.split(",") for mode in args.modes.split(",")]
    for shape, mode in runs:
        b, h = SHAPES[shape]
        store, stream = MODES[mode]
        cfg = SSGConfig(search=25, window=9, sigma=0.004, q_store_dtype=store,
                        stream_dtype=stream)
        sr, gt, mask = (torch.from_numpy(a).cuda() for a in smooth_case(b, h, 3, 0.25))

        def kernel():
            return ssg_cuda.ssg_loss_fwd_cuda(sr, gt, mask, cfg)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = kernel()
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        again = kernel()
        torch.cuda.synchronize()
        repeat = all(torch.equal(x, y) for x, y in zip(got, again))
        same = None
        if args.save:
            os.makedirs(args.save, exist_ok=True)
            torch.save([t.cpu() for t in got],
                       os.path.join(args.save, f"{args.label}-{shape}-{mode}.pt"))
            if args.against:
                theirs = torch.load(os.path.join(args.save, f"{args.against}-{shape}-{mode}.pt"))
                same = all(torch.equal(x.cpu(), y) for x, y in zip(got, theirs))
        errs = None
        if not args.no_check:
            ref = ssl_loss_sums_reference(sr, gt, mask, cfg)
            errs = {key: float(((got[i] - ref[i]).abs() / ref[i].abs().clamp_min(1e-30)).max())
                    for i, key in ((0, "l1"), (1, "kl"), (2, "count"), (3, "inv_sr"),
                                   (4, "inv_gt"), (6, "b_map"))}
            del ref
        device_ms = kernel_device_ms(kernel, "ssg_loss_fwd", max(2, args.iters // 2))
        wrapper_ms = time_ms(kernel, args.iters)
        ops = k1_operations(b, 3, h, h, cfg.search)
        nbytes = 4 * (2 * b * 3 * h * h + b * h * h) + 4 * 4 * b * h * h
        bound_ms = 1e3 * max(ops / PEAK_FP32_PER_S, nbytes / PEAK_BYTES_PER_S)
        print(json.dumps({"label": args.label, "shape": shape, "mode": mode,
                          "b_c_h_w": [b, 3, h, h],
                          "kernel_device_ms": sum(device_ms.values()),
                          "per_kernel_ms": device_ms, "wrapper_ms": wrapper_ms,
                          "call_peak_gb": peak_gb,
                          "bound_ms": bound_ms, "operations": ops, "max_rel_err": errs,
                          "repeat_bit_for_bit": repeat,
                          **({"bit_for_bit_vs_" + args.against: same} if same is not None
                             else {}),
                          "card": name}), flush=True)
        del sr, gt, mask, got, again
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
