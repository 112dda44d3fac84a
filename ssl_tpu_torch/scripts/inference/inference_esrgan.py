"""ESRGAN inference (RRDBNet with the classic ESRGAN defaults), without JAX.

    python -m ssl_tpu_torch.scripts.inference.inference_esrgan --input imgs/ \\
        --model_path net_g.pth [--output results/esrgan] [--scale 4] [--num_feat 64] \\
        [--num_block 23] [--param_key params] [--suffix ESRGAN] [--device cpu]

Counterpart of ``inference/inference_esrgan.py``, with its flags and defaults: every
image of ``--input`` through the net, written as ``<name>_<suffix>.png``.
It runs on the card unless ``--device cpu`` is given."""

from __future__ import annotations

import argparse

from ssl_tpu_torch.scripts.inference.common import add_device_flag, load_net, run_image_folder


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", required=True)
    p.add_argument("--output", default="results/esrgan")
    p.add_argument("--model_path", required=True)
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--num_feat", type=int, default=64)
    p.add_argument("--num_block", type=int, default=23)
    p.add_argument("--param_key", default="params")
    p.add_argument("--suffix", default="ESRGAN")
    add_device_flag(p)
    args = p.parse_args(argv)
    net = load_net(dict(type="RRDBNet", scale=args.scale, num_feat=args.num_feat,
                        num_block=args.num_block), args.model_path, args.param_key, args.device)
    return run_image_folder(net, args)


if __name__ == "__main__":
    main()
