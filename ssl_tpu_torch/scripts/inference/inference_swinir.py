"""SwinIR inference, without JAX.

    python -m ssl_tpu_torch.scripts.inference.inference_swinir --input imgs/ \\
        --model_path net_g.pth [--output results/swinir] [--scale 4] \\
        [--net_opt '{"embed_dim": 180, ...}'] [--param_key params_ema] [--suffix SwinIR] \\
        [--device cpu]

Counterpart of ``inference/inference_swinir.py``, with its flags and
defaults: every image of ``--input`` through SwinIR (``--net_opt`` adds
JSON options to ``upscale``), written as ``<name>_<suffix>.png``.  It runs
on the card unless ``--device cpu`` is given."""

from __future__ import annotations

import argparse
import json

from ssl_tpu_torch.scripts.inference.common import add_device_flag, load_net, run_image_folder


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", required=True)
    p.add_argument("--output", default="results/swinir")
    p.add_argument("--model_path", required=True)
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--net_opt", default=None, help="extra SwinIR opts as JSON")
    p.add_argument("--param_key", default="params_ema")
    p.add_argument("--suffix", default="SwinIR")
    add_device_flag(p)
    args = p.parse_args(argv)
    net_opt = dict(type="SwinIR", upscale=args.scale,
                   **(json.loads(args.net_opt) if args.net_opt else {}))
    return run_image_folder(load_net(net_opt, args.model_path, args.param_key, args.device), args)


if __name__ == "__main__":
    main()
