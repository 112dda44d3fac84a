"""The port's inference entry points (``python -m
ssl_tpu_torch.scripts.inference.<name>``) against the JAX package's CLIs
(inference/*.py) on two seeded 16 x 20 PNGs, with ``--device cpu``.

Weights: RRDBNet (num_feat 8, num_block 1) and a small SwinIR from their
JAX modules' own init (the last conv scaled by 0.1 and its bias moved to
0.5, so that the SR is not clipped flat), written as a reference-layout
``.pth`` (``ssl_tpu/utils/weight_port.py::export_rrdbnet_to_torch``,
``export_swinir_to_torch``) and as the JAX package's ``.pkl``; both CLIs
read the same files.  Holds: every SR PNG within one uint8 level of the JAX
CLI's (float32 convolutions summed in other orders, rounded to uint8);
``inference_ssl_sr`` tiled within one level of whole away from the image's
border (a tile at the border is reflect-padded where the whole image is
zero-padded past its multiple-of-16 pad, in both packages); a checkpoint without
the asked key falls back to ``params`` in both; ``--spatial`` at one rank
runs whole, as the JAX CLI's does on these small images; and
without ``--device`` on a machine without a card the entry point raises."""

import importlib.util
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.archs import build_network as jax_build_network
from ssl_tpu.utils.weight_port import export_rrdbnet_to_torch, export_swinir_to_torch
from ssl_tpu_torch.scripts.inference import (inference_esrgan, inference_rrdbnet,
                                             inference_ssl_sr, inference_swinir)
from ssl_tpu_torch.utils.png import decode_png, encode_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWIN_OPT = {"embed_dim": 12, "depths": [2], "num_heads": [2], "window_size": 4, "img_size": 16,
            "mlp_ratio": 2}
TILE = ["--tile_size", "8", "--tile_pad", "24"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _soften(variables):
    """The last conv scaled by 0.1, its bias 0.5 (see the module doc)."""
    params = dict(variables["params"])
    last = dict(params["conv_last"])
    last["kernel"] = last["kernel"] * 0.1
    last["bias"] = np.full_like(last["bias"], 0.5)
    params["conv_last"] = last
    return params


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer")
    rng = np.random.RandomState(0)
    os.makedirs(root / "lq")
    for name in ("p0.png", "p1.png"):
        yy, xx = np.mgrid[0:16, 0:20] / 20.0
        img = np.stack([0.5 + 0.3 * np.sin((c + 2) * yy + (3 - c) * xx) for c in range(3)], -1)
        img = np.clip(img + 0.05 * rng.randn(16, 20, 3), 0, 1)
        (root / "lq" / name).write_bytes(encode_png(np.round(img * 255).astype(np.uint8)))
    x = jnp.zeros((1, 16, 20, 3))
    rrdb = _soften(_np(jax.jit(jax_build_network(
        {"type": "RRDBNet", "num_feat": 8, "num_block": 1}).init)(jax.random.PRNGKey(1), x)))
    swin = _soften(_np(jax.jit(jax_build_network(
        {"type": "SwinIR", "upscale": 4, **SWIN_OPT}).init)(jax.random.PRNGKey(2), x)))
    export_rrdbnet_to_torch(rrdb, str(root / "rrdb.pth"), "params", also_ema=rrdb)
    export_rrdbnet_to_torch(rrdb, str(root / "rrdb_params_only.pth"), "params")
    export_swinir_to_torch(swin, str(root / "swin.pth"), "params", also_ema=swin)
    for name, tree in (("rrdb.pkl", rrdb), ("swin.pkl", swin)):
        with open(root / name, "wb") as f:
            pickle.dump({"params": tree, "params_ema": tree}, f)
    return root


def _jax_cli(monkeypatch, name, argv):
    """Run ``inference/<name>.py``'s main in this process (its per-arch
    scripts import ``common`` from their folder)."""
    folder = os.path.join(REPO, "inference")
    monkeypatch.syspath_prepend(folder)
    monkeypatch.delitem(sys.modules, "common", raising=False)
    spec = importlib.util.spec_from_file_location(f"jax_infer_{name}",
                                                  os.path.join(folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name] + [str(a) for a in argv])
    mod.main()
    monkeypatch.delitem(sys.modules, "common", raising=False)


def _read(path):
    with open(path, "rb") as f:
        return decode_png(f.read(), "unchanged").astype(np.int64)


def _within_a_level(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names and names == sorted(os.listdir(dir_b))
    for name in names:
        a, b = _read(os.path.join(dir_a, name)), _read(os.path.join(dir_b, name))
        assert a.shape == b.shape == (64, 80, 3), (name, a.shape, b.shape)
        assert np.abs(a - b).max() <= 1, (name, np.abs(a - b).max())
        assert a.std() > 1, name                          # not a flat image


CLIS = {
    "rrdbnet_pth": ("inference_rrdbnet", inference_rrdbnet, "rrdb.pth",
                    ["--num_feat", "8", "--num_block", "1"]),
    "rrdbnet_pkl": ("inference_rrdbnet", inference_rrdbnet, "rrdb.pkl",
                    ["--num_feat", "8", "--num_block", "1"]),
    "rrdbnet_params_fallback": ("inference_rrdbnet", inference_rrdbnet, "rrdb_params_only.pth",
                                ["--num_feat", "8", "--num_block", "1"]),
    "esrgan_pth": ("inference_esrgan", inference_esrgan, "rrdb.pth",
                   ["--num_feat", "8", "--num_block", "1"]),
    "swinir_pth": ("inference_swinir", inference_swinir, "swin.pth",
                   ["--net_opt", '{"embed_dim": 12, "depths": [2], "num_heads": [2], '
                    '"window_size": 4, "img_size": 16, "mlp_ratio": 2}']),
    "swinir_pkl": ("inference_swinir", inference_swinir, "swin.pkl",
                   ["--net_opt", '{"embed_dim": 12, "depths": [2], "num_heads": [2], '
                    '"window_size": 4, "img_size": 16, "mlp_ratio": 2}']),
    "ssl_sr_pth": ("inference_ssl_sr", inference_ssl_sr, "rrdb.pth",
                   ["--num_feat", "8", "--num_block", "1"]),
    "ssl_sr_pkl_tiled": ("inference_ssl_sr", inference_ssl_sr, "rrdb.pkl",
                         ["--num_feat", "8", "--num_block", "1"] + TILE),
}


@pytest.mark.parametrize("case", sorted(CLIS))
def test_inference_cli_matches_jax(files, tmp_path, monkeypatch, case):
    script, port, ckpt, extra = CLIS[case]
    argv = ["--input", files / "lq", "--model_path", files / ckpt] + extra
    _jax_cli(monkeypatch, script, argv + ["--output", tmp_path / "jax"])
    written = port.main([str(a) for a in argv + ["--output", tmp_path / "port", "--device", "cpu"]])
    assert len(written) == 2
    _within_a_level(tmp_path / "jax", tmp_path / "port")
    if script != "inference_ssl_sr":
        suffix = {"inference_rrdbnet": "RRDBNet", "inference_esrgan": "ESRGAN",
                  "inference_swinir": "SwinIR"}[script]
        assert sorted(os.listdir(tmp_path / "port")) == [f"p0_{suffix}.png", f"p1_{suffix}.png"]


def test_ssl_sr_tiled_matches_whole(files, tmp_path):
    """A 48 x 56 LQ in a 6 x 7 grid of 8-pixel tiles with a 20-pixel halo
    (past RRDBNet's receptive field at this depth, 18.25 LQ pixels) against
    the whole image, more than 20 LQ pixels from the border, where the tile
    seams at 24 and 32 lie."""
    rng = np.random.RandomState(5)
    os.makedirs(tmp_path / "big")
    img = np.clip(0.5 + 0.2 * rng.randn(48, 56, 3), 0, 1)
    (tmp_path / "big" / "b.png").write_bytes(encode_png(np.round(img * 255).astype(np.uint8)))
    argv = ["--input", str(tmp_path / "big"), "--model_path", str(files / "rrdb.pth"),
            "--num_feat", "8", "--num_block", "1", "--device", "cpu"]
    inference_ssl_sr.main(argv + ["--output", str(tmp_path / "whole")])
    inference_ssl_sr.main(argv + ["--output", str(tmp_path / "tiled"),
                                  "--tile_size", "8", "--tile_pad", "20"])
    whole, tiled = (_read(str(tmp_path / d / "b.png")) for d in ("whole", "tiled"))
    assert whole.shape == tiled.shape == (192, 224, 3)
    inner = (slice(84, 108), slice(84, 140))
    assert np.abs(whole[inner] - tiled[inner]).max() <= 1


def test_spatial_raises_and_no_card_refuses(files, tmp_path, monkeypatch):
    """``--spatial`` at one rank (no torchrun) runs the whole image through
    spatial_infer, within a level of the JAX CLI's ``--spatial`` (whose 8
    virtual devices find the image too small and run it whole)."""
    argv = ["--input", str(files / "lq"), "--model_path", str(files / "rrdb.pth"),
            "--output", str(tmp_path / "o"), "--num_feat", "8", "--num_block", "1"]
    inference_ssl_sr.main(argv + ["--spatial", "--device", "cpu"])
    _jax_cli(monkeypatch, "inference_ssl_sr", argv[:4] + ["--output", tmp_path / "j"] + argv[6:]
             + ["--spatial"])
    _within_a_level(tmp_path / "o", tmp_path / "j")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is reachable")
    for main in (inference_ssl_sr.main, inference_rrdbnet.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
