"""Shared helpers of the inference entry points, without JAX.

Counterpart of ``inference/common.py`` (the reference's inference/*.py, one
thin entry point per released model family over one load-and-run core):
``load_net`` builds a registered arch and loads a checkpoint, a port or
reference-layout ``.pth`` or the JAX package's ``.pkl``
(``models/base_model.py::load_network``); ``run_image_folder`` runs it on
every image of ``--input`` without grad on ``resolve_device(--device)``,
the card unless ``--device cpu`` is given."""

from __future__ import annotations

import os
import pickle

import torch

from ssl_tpu_torch.models.base_model import load_network
from ssl_tpu_torch.utils.device import resolve_device
from ssl_tpu_torch.utils.img_util import img2array, img2tensor, imread, imwrite, tensor2img
from ssl_tpu_torch.utils.registry import build_network


def add_device_flag(parser) -> None:
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu only when named here)")


def checkpoint_key(path: str, param_key: str) -> str:
    """``param_key`` where the checkpoint holds it, else ``params`` (the JAX
    CLIs retry with ``params``, inference/common.py:26-27)."""
    if path.endswith((".pkl", ".pickle")):
        with open(path, "rb") as f:
            payload = pickle.load(f)
    else:                               # mmap: the keys without reading the tensors
        payload = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return param_key if isinstance(payload, dict) and param_key in payload else "params"


def load_net(net_opt: dict, model_path: str, param_key: str = "params_ema", device=None):
    """The registered arch of ``net_opt`` with the weights of ``model_path``
    under ``param_key`` (falling back to ``params``), in eval mode on
    ``device``."""
    net = build_network(dict(net_opt))
    load_network(net, model_path, checkpoint_key(model_path, param_key))
    return net.to(resolve_device(device)).eval()


def iter_images(input_path: str):
    exts = (".png", ".jpg", ".jpeg", ".bmp")
    if os.path.isdir(input_path):
        for name in sorted(os.listdir(input_path)):
            if name.lower().endswith(exts):
                yield os.path.join(input_path, name)
    else:
        yield input_path


@torch.no_grad()
def run_image_folder(net, args) -> list[str]:
    """Run a (b, 3, h, w) -> (b, 3, H, W) net over ``args.input`` on the
    net's device and write ``<name>_<args.suffix>.png`` to ``args.output``;
    returns the files written."""
    device = next(net.parameters()).device
    os.makedirs(args.output, exist_ok=True)
    written = []
    for path in iter_images(args.input):
        x = img2tensor(img2array(imread(path)))[None].to(device)
        base = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.output, f"{base}_{args.suffix}.png")
        imwrite(tensor2img(net(x)), out_path)
        print(f"{path} -> {base}_{args.suffix}.png")
        written.append(out_path)
    return written
