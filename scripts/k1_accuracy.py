"""K1's accuracy on generator SR, against its plain version run in float64.

    python3 scripts/k1_accuracy.py [--root DIR] [--label NAME]

Inputs, each with search 25 / window 9 / sigma 0.004:

* ``bsrgan_seed<s>``: BSRGAN-SSL's SR (the full-width BSRGANRRDBNet of
  options/train/BSRGANSSL/train_BSRGANSSL_DF2K_OST_x4.json at its seeded
  init) of 16 training pairs of that file's DatasetBlindSRMask (the BSRGAN
  degradation, cv2 hidden) for each seed of chip_smoke.KR_HOLD_SEEDS, with
  the stride-3 mask, as chip_smoke.py's kair phase holds K1 on them;
* ``wide_range``: the SR of the same G drawn with flax's init variance
  (chip_smoke.flax_variance_init, the JAX package's init): std about 9,
  values in about [-20, 35].

For each input it runs K1 (``ssg_loss_fwd_cuda``), the plain version in
float32 and the plain version in float64 (the truth), and prints one JSON
line with, for K1 and for the plain float32 version:

* each forward output's error against float64: l1 and kl relative; inv_sr
  and inv_gt the largest relative error; a_map and b_map the largest
  absolute error over the map's largest value, and the elements off rtol
  1e-4 with an atol of 1e-6 of the largest value;
* d_sr (the plain backward in float32 fed that route's maps, the gradient of
  l1 + kl) against the float64 backward fed the float64 maps, on the mask
  with the pixels whose sign(x - y) or [x > 1e-10] is tied in float64 taken
  out (chip_smoke.near_ties): the worst element in units of the strict bound
  (rtol 1e-4, atol 1e-6 of the largest |d_sr|) and the elements over it;
* where the d_sr error enters: the float64 backward fed that route's maps
  (the forward's error alone), and the float32 backward fed the float64 maps
  (the backward's own).

``--root`` imports ``ssl_tpu_torch`` from another checkout (an earlier commit
unpacked with ``git archive``), so that two versions of K1 are measured on
one card in one call.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = "BSRGANSSL"


def map_errors(got, ref) -> dict:
    """Errors of one route's forward outputs ``got`` against ``ref`` (float64)."""
    out = {}
    for i, key in ((0, "l1"), (1, "kl")):
        out[key] = float(abs(got[i].double() - ref[i]) / abs(ref[i]))
    for i, key in ((3, "inv_sr"), (4, "inv_gt")):
        out[key] = float(((got[i].double() - ref[i]).abs() / ref[i].abs()).max())
    for i, key in ((5, "a_map"), (6, "b_map")):
        diff = (got[i].double() - ref[i]).abs()
        top = float(ref[i].abs().max())
        out[f"{key}_max_abs_over_max"] = float(diff.max()) / top
        out[f"{key}_off"] = int((diff > 1e-4 * ref[i].abs() + 1e-6 * top).sum())
    return out


def over_bound(d, d64) -> dict:
    """d's error against ``d64`` in units of the strict bound."""
    bound = max(1e-7, 1e-6 * float(d64.abs().max())) + 1e-4 * d64.abs()
    ratio = (d.double() - d64).abs() / bound
    return {"worst_over_strict_bound": float(ratio.max()), "off_strict": int((ratio > 1).sum())}


def measure(label: str, sr, gt, mask, cfg) -> dict:
    import torch
    from chip_smoke import near_ties
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.ops.ssg import ssl_loss_dense_bwd, ssl_loss_sums_reference

    sr64, gt64, mask64 = sr.double(), gt.double(), mask.double()
    ref = ssl_loss_sums_reference(sr64, gt64, mask64, cfg)
    routes = {"k1": ssg_cuda.ssg_loss_fwd_cuda(sr, gt, mask, cfg),
              "plain32": ssl_loss_sums_reference(sr, gt, mask, cfg)}
    tied = near_ties(sr64, gt64, ref, cfg)[0]
    m32 = mask * ~tied
    m64 = m32.double()
    one32 = torch.ones((), device=sr.device)
    one64 = one32.double()
    d64 = ssl_loss_dense_bwd(sr64, gt64, m64, ref[3], ref[4], one64, one64, cfg, ref[5], ref[6])
    f32_bwd_f64_maps = ssl_loss_dense_bwd(sr, gt, m32, *(ref[i].float() for i in (3, 4)),
                                          one32, one32, cfg, ref[5].float(), ref[6].float())
    out = {"label": label, "shape": list(sr.shape), "sr_range": [float(sr.min()),
                                                                 float(sr.max())],
           "sr_std": float(sr.std()), "mask_share": float(mask.mean()),
           "tied_pixels_out": int((tied & (mask > 0)).sum()),
           "d_sr_max_abs": float(d64.abs().max()),
           "f32_backward_fed_f64_maps": over_bound(f32_bwd_f64_maps, d64)}
    for name, fwd in routes.items():
        d = ssl_loss_dense_bwd(sr, gt, m32, fwd[3], fwd[4], one32, one32, cfg, fwd[5], fwd[6])
        d_fwd_only = ssl_loss_dense_bwd(sr64, gt64, m64, *(fwd[i].double() for i in (3, 4)),
                                        one64, one64, cfg, fwd[5].double(), fwd[6].double())
        out[name] = {"maps": map_errors(fwd, ref), "d_sr": over_bound(d, d64),
                     "d_sr_f64_backward_fed_these_maps": over_bound(d_fwd_only, d64)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT, help="checkout whose ssl_tpu_torch is measured")
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (KR_HOLD, KR_HOLD_SEEDS, card, flax_variance_init, kair_file,
                            kair_fixtures, kair_pairs)
    sys.path.insert(0, os.path.abspath(args.root))      # this checkout's ssl_tpu_torch
    from ssl_tpu_torch.ops import ssg_cuda
    from ssl_tpu_torch.ops.ssg import SSGConfig
    from ssl_tpu_torch.utils.kair_options import kair_to_opt
    from ssl_tpu_torch.utils.options import parse_json_options
    from ssl_tpu_torch.utils.registry import build_network
    if not ssg_cuda.__file__.startswith(os.path.abspath(args.root)):
        print(f"ssl_tpu_torch came from {ssg_cuda.__file__}, not {args.root}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    cfg = SSGConfig(search=25, window=9, sigma=0.004)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="k1_accuracy_") as root:
        d, _ = kair_fixtures(os.path.join(root, "data"), "cuda")
        path, _ = kair_file(RECIPE, d, root)
        opt = kair_to_opt(parse_json_options(path))
        opt.update(is_train=True, num_devices=1)
        sets = {seed: kair_pairs(opt, KR_HOLD, "cuda", seed)[0] for seed in KR_HOLD_SEEDS}
    net = build_network(opt["network_g"])
    inputs = []
    with torch.no_grad():
        net.reset_parameters(torch.Generator().manual_seed(0))
        net = net.cuda().eval()
        for seed, p in sets.items():
            inputs.append((f"bsrgan_seed{seed}", net(p["lq"]).contiguous(), p))
        flax_variance_init(net, torch.Generator().manual_seed(0))
        p = sets[KR_HOLD_SEEDS[0]]
        inputs.append(("wide_range", net.cuda()(p["lq"]).contiguous(), p))
    del net
    setup_s = time.perf_counter() - t0
    for label, sr, p in inputs:
        out = measure(label, sr, p["gt"], p["mask"], cfg)
        out.update(version=args.label, card=name, setup_s=setup_s)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
