"""K2's backward at the diffusion training path's shapes, or with ``--fwd``
its forward at the serving path's shapes, on one CUDA device.

    python3 scripts/profile_torch_attention_bwd.py [--fwd] [--dtype float32|bfloat16]
        [--root DIR] [--label NAME] [--iters 10] [--cases ...] [--shapes serve|train]
        [--save DIR [--against LABEL]]

For each case of ``tests/torch_attention_cases.py::TRAIN_CASES`` prints one
JSON line: the device time of every backward kernel (torch.profiler, ms per
call), their sum, the wrapper's time by CUDA events (the kernels, di's
reduction and the allocations) and its device time (every CUDA kernel of
the call, from the profiler), the time of SDPA's backward on the same
inputs by CUDA events and on the device (the yardstick; the port never
calls it), and the bound by the arithmetic the kernels use, per kernel
(``bound_ms``) and for the whole backward, with each kernel's fraction of
its bound.  At d = 512 also cuBLAS's device time for the function of each of
the two products' kernels, dkv_mm (dV and dK) and dq_mm (dQ): one
``torch.baddbmm`` a product on a scratch-shaped tensor in the kernels' type
(``mm_library_device_ms``; bf16's reduced-precision reduction off).
``--dtype bfloat16`` runs the bf16 kernels on the cases'
inputs rounded to bf16 (the float32 forward's o, rounded, and lse), SDPA's
backward in bf16 beside them, and the bound with bf16 products and 2-byte
operands.  With ``--fwd``, for each case of ``CUDA_CASES``: the forward
kernels' device times, the wrapper's time, SDPA's forward by CUDA events and
on the device, the plain version's time, the bound and the kernels' fraction
of it, the error (against the plain version; with ``--dtype bfloat16`` the
relative L2 error against the float32 plain version and its hold), and
whether a second launch repeats the first bit for bit; with ``--save DIR``
it writes each case's o and lse to ``DIR/<label>-<case>.pt``, and with
``--against LABEL`` compares them bit for bit with what a run labelled
LABEL saved there.  ``--shapes`` takes
the cases of the other path instead (``train``: the forward at the training
batch, as the mini-step runs it; ``serve``: the backward at the serving
batch).
``--root`` imports ``ssl_tpu_torch`` from another checkout (for example an
earlier commit unpacked with ``git archive``), so that two versions are
timed in turns on one card.  TF32 is off for the yardstick's and the plain
version's products.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT, help="checkout whose ssl_tpu_torch is timed")
    ap.add_argument("--label", default="change")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cases", nargs="*", default=None)
    ap.add_argument("--fwd", action="store_true", help="the forward at the serving shapes")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="the kernels' input type")
    ap.add_argument("--shapes", default=None, choices=("serve", "train"),
                    help="the serving (CUDA_CASES) or training (TRAIN_CASES) shapes; by "
                         "default serve with --fwd, else train")
    ap.add_argument("--save", default=None, help="with --fwd: directory for o and lse")
    ap.add_argument("--against", default=None,
                    help="with --save: label of an earlier run whose o and lse must be equal")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(1, os.path.join(ROOT, "tests"))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card, device_ms, k2_bwd_times, kernel_device_ms, mm_library_ms, time_ms
    from torch_attention_cases import CUDA_CASES, TRAIN_CASES, attention_inputs
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
    dtype = getattr(torch, args.dtype)
    cases = CUDA_CASES if args.shapes == "serve" else TRAIN_CASES
    for case in args.cases or list(cases):
        b, h, n, m, d, scale, layout, logits = cases[case]
        q, k, v = attention_inputs(b, h, n, m, d, scale, layout, logits, device="cuda",
                                   dtype=dtype)
        do = torch.randn((b, n, h, d), generator=torch.Generator(device="cuda").manual_seed(11),
                         device="cuda").to(dtype)
        if dtype == torch.float32:
            o, lse = attention_cuda.flash_attn_fwd_cuda(q, k, v, scale, return_lse=True)
        else:       # as chip_smoke.py's k2_bwd_bf16 phase: the float32 reference's o and lse
            from ssl_tpu_torch.ops.attention import (attention_lse_reference,
                                                     sdp_attention_reference)
            q32, k32 = q.float(), k.float()
            o = sdp_attention_reference(q32, k32, v.float(), scale).to(dtype)
            lse = attention_lse_reference(q32, k32, scale)
            del q32, k32

        def kernel():
            attention_cuda.flash_attn_bwd_cuda(q, k, v, o, lse, do, scale)

        per_kernel = kernel_device_ms(kernel, "flash_attn_bwd", args.iters)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        do_t = do.transpose(1, 2)
        wrapper_ms = time_ms(kernel, args.iters)

        def sdpa_bwd():
            torch.autograd.grad(sdpa_out, (qt, kt, vt), do_t, retain_graph=True)

        sdpa_ms = time_ms(sdpa_bwd, args.iters)
        # device times, which the host's dispatch does not move: the wrapper's
        # (the kernels, di's reduction and its copies) and SDPA's backward
        wrapper_device_ms = device_ms(kernel, args.iters)
        sdpa_device_ms = device_ms(sdpa_bwd, args.iters)
        plan = getattr(attention_cuda, "bwd_plan", None)      # absent before the redesign
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = None
        if plan:     # an older checkout's plan may take no dtype
            splits = (plan(b, h, n, m, d, sms, dtype) if dtype != torch.float32
                      else plan(b, h, n, m, d, sms))[:2]
        mm_library = None
        if d == 512:      # the products' function alone, on a scratch of P and dS's shape
            gen = torch.Generator(device="cuda").manual_seed(5)
            p_ds = torch.rand((2, b, h, n, m), generator=gen, device="cuda").to(dtype)
            mm_library = mm_library_ms(p_ds, q, k, do, scale)
            del p_ds
        bounds = k2_bwd_times(b, h, n, m, d, splits or (1, 1), args.dtype)
        bound_ms = {k_: max(v_["ops_ms"], v_["bytes_ms"]) for k_, v_ in bounds.items()}
        fraction = {k_: bound_ms[re.sub(r"^flash_attn_bwd_|(_bf16)?_kernel$", "", k_)] / t
                    for k_, t in per_kernel.items()}
        print(json.dumps({"label": args.label, "case": case, "dtype": args.dtype,
                          "b_heads_n_m_d": [b, h, n, m, d],
                          "kernels_device_ms": sum(per_kernel.values()),
                          "per_kernel_ms": per_kernel, "wrapper_ms": wrapper_ms,
                          "wrapper_device_ms": wrapper_device_ms, "sdpa_bwd_ms": sdpa_ms,
                          "sdpa_bwd_device_ms": sdpa_device_ms,
                          "mm_library_device_ms": mm_library, "bound": bounds["bwd"],
                          "bound_ms": bound_ms,
                          "fraction_of_bound": fraction, "splits": splits,
                          "card": name}), flush=True)
        del q, k, v, o, lse, do, qt, kt, vt, sdpa_out
        torch.cuda.empty_cache()
    return 0


def profile_fwd(args, attention_cuda, name) -> int:
    """The forward's lines (``--fwd``): in float32, the error is the largest
    against the plain version and the hold its elementwise one; in bf16
    (``--dtype bfloat16``) the relative L2 error against the float32 plain
    version on the same inputs upcast, held by BF16_FWD_REL_L2 and
    BF16_PLAIN_RATIO times the plain bf16 route's error."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import device_ms, k2_times, kernel_device_ms, rel_l2, time_ms
    from torch_attention_cases import (BF16_FWD_REL_L2, BF16_PLAIN_RATIO, CUDA_CASES,
                                       TRAIN_CASES, attention_inputs)
    from ssl_tpu_torch.ops.attention import sdp_attention_reference
    dtype = getattr(torch, args.dtype)
    plan = getattr(attention_cuda, "fwd_plan", None)      # absent before the redesign
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = TRAIN_CASES if args.shapes == "train" else CUDA_CASES
    for case in args.cases or list(cases):
        b, h, n, m, d, scale, layout, logits = cases[case]
        q, k, v = attention_inputs(b, h, n, m, d, scale, layout, logits, device="cuda",
                                   dtype=dtype)

        def kernel():
            return attention_cuda.flash_attn_fwd_cuda(q, k, v, scale)

        got, again = kernel(), kernel()
        ref = sdp_attention_reference(q.float(), k.float(), v.float(), scale)
        torch.cuda.synchronize()
        same = None
        if args.save:
            os.makedirs(args.save, exist_ok=True)
            saved = [t.cpu() for t in attention_cuda.flash_attn_fwd_cuda(q, k, v, scale,
                                                                         return_lse=True)]
            torch.save(saved, os.path.join(args.save, f"{args.label}-{case}.pt"))
            if args.against:
                theirs = torch.load(os.path.join(args.save, f"{args.against}-{case}.pt"))
                same = all(torch.equal(x, y) for x, y in zip(saved, theirs))
        err = float((got.float() - ref).abs().max())
        if dtype == torch.float32:
            errors = {"max_abs_err": err}
            within = bool(((got - ref).abs() <= 1e-5 * float(ref.abs().max())
                           + 1e-4 * ref.abs()).all())
        else:
            rel, plain_rel = rel_l2(got, ref), rel_l2(sdp_attention_reference(q, k, v, scale), ref)
            errors = {"max_abs_err": err, "rel_l2_vs_float32": rel,
                      "plain_bf16_rel_l2_vs_float32": plain_rel}
            within = rel <= BF16_FWD_REL_L2 and rel <= BF16_PLAIN_RATIO * plain_rel
        per_kernel = kernel_device_ms(kernel, "flash_attn_fwd", args.iters)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, scale=scale)

        wrapper_ms = time_ms(kernel, args.iters)
        sdpa_ms = time_ms(sdpa, args.iters)
        sdpa_device_ms = device_ms(sdpa, args.iters)
        plain_ms = time_ms(lambda: sdp_attention_reference(q, k, v, scale), args.iters)
        bound = k2_times(b, h, n, m, d, args.dtype)
        bound_ms = max(bound["ops_ms"], bound["bytes_ms"])
        split = None
        if plan:     # an older checkout's plan may take no dtype
            split = (plan(b, h, n, m, d, sms, dtype) if dtype != torch.float32
                     else plan(b, h, n, m, d, sms))[0]
        total = sum(per_kernel.values())
        print(json.dumps({"label": args.label, "case": case, "dtype": args.dtype,
                          "b_heads_n_m_d": [b, h, n, m, d], "kernels_device_ms": total,
                          "per_kernel_ms": per_kernel, "wrapper_ms": wrapper_ms,
                          "sdpa_ms": sdpa_ms, "sdpa_device_ms": sdpa_device_ms,
                          "plain_ms": plain_ms, "bound": bound, "bound_ms": bound_ms,
                          "fraction_of_bound": bound_ms / total, "split": split, **errors,
                          "within_hold": within,
                          "repeat_bit_for_bit": bool(torch.equal(got, again)),
                          **({"bit_for_bit_vs_" + args.against: same} if same is not None
                             else {}),
                          "card": name}),
              flush=True)
        del q, k, v, got, again, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
