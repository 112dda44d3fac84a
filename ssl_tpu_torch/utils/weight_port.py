"""Carry weights from the JAX package's flax trees into the port's modules.

``params_from_jax(family, params, batch_stats=None)`` takes a flax ``params``
tree as nested dicts of numpy arrays (and, for the discriminator, its
``batch_stats``) and returns a state dict for the port's module of that
family, so both compute the same function from the same weights.  It reads
numpy only.  Conventions: conv kernels HWIO -> OIHW, Dense (in, out) ->
Linear (out, in), BatchNorm scale/bias/mean/var -> weight/bias/running_*.
Load the result with ``load_state_dict(sd, strict=False)``: batch norms'
``num_batches_tracked`` counters have no flax counterpart."""

from __future__ import annotations

import numpy as np
import torch

FAMILIES = ("RRDBNet", "VGGStyleDiscriminator", "VGGFeatureExtractor")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True, order="C"))


def _conv(sd: dict, name: str, node: dict, index=None) -> None:
    k = np.asarray(node["kernel"])
    if index is not None:
        k = k[index]
    sd[f"{name}.weight"] = _t(k.transpose(3, 2, 0, 1))
    if "bias" in node:
        b = np.asarray(node["bias"])
        sd[f"{name}.bias"] = _t(b[index] if index is not None else b)


def _rrdbnet(params: dict) -> dict:
    sd: dict = {}
    for name in ("conv_first", "conv_body", "conv_up1", "conv_up2", "conv_hr", "conv_last"):
        _conv(sd, name, params[name])
    body = params.get("body")
    if body is not None:  # scanned trunk: leaves stacked on a leading block axis
        cell = body["RRDB_0"]
        n_blocks = np.asarray(
            cell["ResidualDenseBlock_0"]["Conv3x3_0"]["Conv_0"]["kernel"]).shape[0]
        blocks = [(i, cell, i) for i in range(n_blocks)]
    else:
        n_blocks = sum(1 for k in params if k.startswith("body_"))
        blocks = [(i, params[f"body_{i}"], None) for i in range(n_blocks)]
    for i, blk, index in blocks:
        for j in range(3):
            for kk in range(5):
                leaf = blk[f"ResidualDenseBlock_{j}"][f"Conv3x3_{kk}"]["Conv_0"]
                _conv(sd, f"body.{i}.rdb{j + 1}.conv{kk + 1}", leaf, index)
    return sd


def _vgg_disc(params: dict, batch_stats: dict | None) -> dict:
    sd: dict = {}
    n_conv = sum(1 for k in params if k.startswith("Conv_"))
    convs = ["conv0_0", "conv0_1"] + [f"conv{i}_{j}" for i in range(1, n_conv // 2)
                                      for j in (0, 1)]
    for n, name in enumerate(convs):
        _conv(sd, name, params[f"Conv_{n}"])
    for n, name in enumerate(convs[1:]):
        bn, node = name.replace("conv", "bn"), params[f"BatchNorm_{n}"]
        sd[f"{bn}.weight"], sd[f"{bn}.bias"] = _t(node["scale"]), _t(node["bias"])
        if batch_stats is not None:
            st = batch_stats[f"BatchNorm_{n}"]
            sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"] = _t(st["mean"]), _t(st["var"])
    # the flax head flattens NHWC; torch flattens NCHW: reorder the rows
    k = np.asarray(params["Dense_0"]["kernel"])            # (s*s*c, 100)
    c = np.asarray(params[f"Conv_{n_conv - 1}"]["kernel"]).shape[-1]
    s = int(round((k.shape[0] // c) ** 0.5))
    k = k.reshape(s, s, c, -1).transpose(3, 2, 0, 1).reshape(k.shape[-1], -1)
    sd["linear1.weight"], sd["linear1.bias"] = _t(k), _t(params["Dense_0"]["bias"])
    sd["linear2.weight"] = _t(np.asarray(params["Dense_1"]["kernel"]).T)
    sd["linear2.bias"] = _t(params["Dense_1"]["bias"])
    return sd


def _vgg_features(params: dict) -> dict:
    sd: dict = {}
    for name, node in params.items():
        _conv(sd, f"convs.{name}", node)
    return sd


def params_from_jax(family: str, params: dict, batch_stats: dict | None = None) -> dict:
    """State dict for the port's ``family`` module from a flax params tree."""
    if family == "RRDBNet":
        return _rrdbnet(params)
    if family == "VGGStyleDiscriminator":
        return _vgg_disc(params, batch_stats)
    if family == "VGGFeatureExtractor":
        return _vgg_features(params)
    raise KeyError(f"no weight carry for {family!r}; known: {FAMILIES}")
