"""K2's backward at the diffusion training path's shapes, or with ``--fwd``
its forward at the serving path's shapes, on one CUDA device.

    python3 scripts/profile_torch_attention_bwd.py [--fwd] [--root DIR] [--label NAME] [--iters 10]

For each case of ``tests/torch_attention_cases.py::TRAIN_CASES`` prints one
JSON line: the device time of every backward kernel (torch.profiler, ms per
call), their sum, the wrapper's time by CUDA events (the kernels, di's
reduction and the allocations), the time of SDPA's backward on the same
inputs (the yardstick; the port never calls it) and the bound by the
arithmetic the kernels use.  With ``--fwd``, for each case of
``CUDA_CASES``: the forward kernels' device times, the wrapper's time, SDPA's
and the plain version's forward, the bound, the largest error against the
plain version and whether a second launch repeats the first bit for bit.
``--root`` imports ``ssl_tpu_torch`` from another checkout (for example an
earlier commit unpacked with ``git archive``), so that two versions are
timed in turns on one card.  TF32 is off for the yardstick's and the plain
version's products.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT, help="checkout whose ssl_tpu_torch is timed")
    ap.add_argument("--label", default="change")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cases", nargs="*", default=None)
    ap.add_argument("--fwd", action="store_true", help="the forward at the serving shapes")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(1, os.path.join(ROOT, "tests"))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card, k2_bwd_times, kernel_device_ms, time_ms
    from torch_attention_cases import TRAIN_CASES, attention_inputs
    sys.path.insert(0, os.path.abspath(args.root))      # this checkout's ssl_tpu_torch
    from ssl_tpu_torch.ops import attention_cuda
    if not attention_cuda.__file__.startswith(os.path.abspath(args.root)):
        print(f"ssl_tpu_torch came from {attention_cuda.__file__}, not {args.root}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    if args.fwd:
        return profile_fwd(args, attention_cuda, name)
    for case in args.cases or list(TRAIN_CASES):
        b, h, n, m, d, scale, layout, logits = TRAIN_CASES[case]
        q, k, v = attention_inputs(b, h, n, m, d, scale, layout, logits, device="cuda")
        do = torch.randn((b, n, h, d), generator=torch.Generator(device="cuda").manual_seed(11),
                         device="cuda")
        o, lse = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)

        def kernel():
            attention_cuda.flash_attn_bwd_cuda(q, k, v, o, lse, do, scale)

        per_kernel = kernel_device_ms(kernel, "flash_attn_bwd", args.iters)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        do_t = do.transpose(1, 2)
        wrapper_ms = time_ms(kernel, args.iters)
        sdpa_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), do_t,
                                                      retain_graph=True), args.iters)
        bounds = k2_bwd_times(b, h, n, m, d)["bwd"]
        plan = getattr(attention_cuda, "bwd_plan", None)      # absent before the redesign
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = plan(b, h, n, m, d, sms)[:2] if plan else None
        print(json.dumps({"label": args.label, "case": case, "b_heads_n_m_d": [b, h, n, m, d],
                          "kernels_device_ms": sum(per_kernel.values()),
                          "per_kernel_ms": per_kernel, "wrapper_ms": wrapper_ms,
                          "sdpa_bwd_ms": sdpa_ms, "bound": bounds, "splits": splits,
                          "card": name}), flush=True)
        del q, k, v, o, lse, do, qt, kt, vt, sdpa_out
        torch.cuda.empty_cache()
    return 0


def profile_fwd(args, attention_cuda, name) -> int:
    """The forward's lines (``--fwd``)."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import k2_times, kernel_device_ms, time_ms
    from torch_attention_cases import CUDA_CASES, attention_inputs
    from ssl_tpu_torch.ops.attention import sdp_attention_reference
    plan = getattr(attention_cuda, "fwd_plan", None)      # absent before the redesign
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case in args.cases or list(CUDA_CASES):
        b, h, n, m, d, scale, layout, logits = CUDA_CASES[case]
        q, k, v = attention_inputs(b, h, n, m, d, scale, layout, logits, device="cuda")

        def kernel():
            return attention_cuda.flash_attn_fwd_cuda(q, k, v, scale)

        got, again = kernel(), kernel()
        ref = sdp_attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        within = bool(((got - ref).abs() <= 1e-5 * float(ref.abs().max()) + 1e-4 * ref.abs()).all())
        per_kernel = kernel_device_ms(kernel, "flash_attn_fwd", args.iters)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        wrapper_ms = time_ms(kernel, args.iters)
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale),
                          args.iters)
        plain_ms = time_ms(lambda: sdp_attention_reference(q, k, v, scale), args.iters)
        bound = k2_times(b, h, n, m, d)
        print(json.dumps({"label": args.label, "case": case, "b_heads_n_m_d": [b, h, n, m, d],
                          "kernels_device_ms": sum(per_kernel.values()),
                          "per_kernel_ms": per_kernel, "wrapper_ms": wrapper_ms,
                          "sdpa_ms": sdpa_ms, "plain_ms": plain_ms, "bound": bound,
                          "split": plan(b, h, n, m, d, sms)[0] if plan else None,
                          "max_abs_err": err, "within_hold": within,
                          "repeat_bit_for_bit": bool(torch.equal(got, again)), "card": name}),
              flush=True)
        del q, k, v, got, again, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
