"""Single-image / folder SR inference through ``SRModel``, without JAX.

    python -m ssl_tpu_torch.scripts.inference.inference_ssl_sr --input imgs/ --output out/ \\
        --model_path experiments/.../net_g_400000.pth [--arch RRDBNet] [--scale 4] \\
        [--tile_size 400 --tile_pad 32] [--device cpu]

Counterpart of ``inference/inference_ssl_sr.py``, with its flags: an
``SRModel`` of ``--arch`` (``--net_opt`` adds JSON options) takes the
weights of ``--model_path`` under ``--param_key`` (``params`` where the file
lacks it; a port ``.pth``, a reference-layout one or the JAX package's
``.pkl``) and restores every file of ``--input`` whole (reflect-padded to a
multiple of 16) or in tiles of ``--tile_size`` with a ``--tile_pad`` halo,
writing it under its own name to ``--output``.  It runs on the card unless
``--device cpu`` is given.  ``--spatial`` shards the image height over the
ranks, each band's window taking ``--spatial_halo`` rows from its
neighbours (``parallel/spatial.py``);
under ``torchrun`` (one rank per card, gloo with ``--device cpu``) every rank
runs and rank 0 writes:

    torchrun --nproc_per_node 2 -m ssl_tpu_torch.scripts.inference.inference_ssl_sr \\
        --input imgs/ --output out/ --model_path net_g.pth --spatial

Without ``torchrun`` one rank runs the whole image."""

from __future__ import annotations

import argparse
import json
import os

from ssl_tpu_torch.scripts.inference.common import add_device_flag, checkpoint_key


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--arch", default="RRDBNet")
    parser.add_argument("--scale", type=int, default=4)
    parser.add_argument("--num_feat", type=int, default=64)
    parser.add_argument("--num_block", type=int, default=23)
    parser.add_argument("--param_key", default="params_ema")
    parser.add_argument("--net_opt", default=None,
                        help='extra network_g options as JSON, e.g. \'{"num_grow_ch": 32}\'')
    parser.add_argument("--tile_size", type=int, default=0, help="0 = no tiling")
    parser.add_argument("--tile_pad", type=int, default=32)
    parser.add_argument("--spatial", action="store_true",
                        help="shard the image height across the ranks (torchrun)")
    parser.add_argument("--spatial_halo", type=int, default=32)
    add_device_flag(parser)
    return parser.parse_args(argv)


def main(argv=None) -> list[str]:
    """Restore the images; returns the files written (none on a rank > 0)."""
    args = parse_args(argv)
    device = args.device
    if args.spatial and "WORLD_SIZE" in os.environ:
        from ssl_tpu_torch.parallel.mesh import init_distributed
        device = init_distributed("cuda" if device is None else device)
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.parallel.mesh import is_main
    from ssl_tpu_torch.models.base_model import TrainState, load_network
    from ssl_tpu_torch.utils.img_util import img2array, img2tensor, imread, imwrite, tensor2img

    opt = {
        "name": "inference", "model_type": "SRModel", "scale": args.scale,
        "is_train": False, "manual_seed": 0,
        "network_g": {"type": args.arch, "num_feat": args.num_feat,
                      "num_block": args.num_block,
                      **(json.loads(args.net_opt) if args.net_opt else {})},
        "path": {},
        "tile_process": args.tile_size > 0,
        "tile_size": args.tile_size, "tile_pad": args.tile_pad,
        "spatial_infer": args.spatial, "spatial_halo": args.spatial_halo,
    }
    model = build_model(opt, device=device)
    net_g = model.build_g()              # every weight is loaded: no seeded init first
    load_network(net_g, args.model_path, checkpoint_key(args.model_path, args.param_key))
    state = TrainState(step=0, net_g=net_g.to(model.device).eval())

    main_rank = is_main()
    if main_rank:
        os.makedirs(args.output, exist_ok=True)
    paths = ([os.path.join(args.input, p) for p in sorted(os.listdir(args.input))]
             if os.path.isdir(args.input) else [args.input])
    written = []
    for path in paths:
        sr = model.test(state, img2tensor(img2array(imread(path))))
        if not main_rank:
            continue
        out_path = os.path.join(args.output, os.path.basename(path))
        imwrite(tensor2img(sr), out_path)
        print(f"{path} -> {out_path}")
        written.append(out_path)
    return written


if __name__ == "__main__":
    main()
