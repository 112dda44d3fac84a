"""Carry weights from the JAX package's flax trees into the port's modules.

``params_from_jax(family, params, batch_stats=None)`` takes a flax ``params``
tree as nested dicts of numpy arrays (and, for the discriminators, their
``batch_stats``) and returns a state dict for the port's module of that
family, so both compute the same function from the same weights.  It reads
numpy only.  Conventions: conv kernels HWIO -> OIHW, Dense (in, out) ->
Linear (out, in) (or Conv1d (out, in, 1) where the torch module is a
kernel-1 Conv1d), norm scale -> weight, BatchNorm mean/var -> running_*,
a spectral norm's ``u`` and ``sigma`` -> the buffers of the same names.
Load the result with ``load_state_dict(sd, strict=False)``: batch norms'
``num_batches_tracked`` counters have no flax counterpart (the diffusion
families load strictly).

The diffusion families name their torch modules as StableSR and ldm do; the
flax names encode those paths (``input_blocks_1_0`` / ``in_layers_2`` is
``input_blocks.1.0.in_layers.2``, ``down_0_block_1`` / ``GroupNorm_0`` is
``down.0.block.1.norm1``), and the maps below undo the encoding."""

from __future__ import annotations

import re

import numpy as np
import torch

FAMILIES = ("RRDBNet", "VGGStyleDiscriminator", "UNetDiscriminatorSN", "VGGFeatureExtractor",
            "UNetModelDualcondV2",
            "EncoderUNetModelWT", "AutoencoderKL", "StableSRSSL")


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


def _unet_disc(params: dict, batch_stats: dict | None) -> dict:
    """UNetDiscriminatorSN: conv0 and conv9 plain; conv1-8 spectrally
    normalized, their raw kernel under ``Conv_0`` and, in ``batch_stats``,
    ``SpectralNorm_0``'s ``Conv_0/kernel/u`` (1, out) and ``.../sigma``."""
    sd: dict = {}
    for name, node in params.items():
        _conv(sd, name, node.get("Conv_0", node))
        if batch_stats is not None and name in batch_stats:
            sn = batch_stats[name]["SpectralNorm_0"]
            sd[f"{name}.u"] = _t(sn["Conv_0/kernel/u"])
            sd[f"{name}.sigma"] = _t(sn["Conv_0/kernel/sigma"])
    return sd


def _vgg_features(params: dict) -> dict:
    sd: dict = {}
    for name, node in params.items():
        _conv(sd, f"convs.{name}", node)
    return sd


def _leaves(sd: dict, name: str, node: dict, conv1d: bool = False) -> None:
    """One flax layer (kernel / scale / bias leaves) into ``sd`` under ``name``."""
    for leaf, value in node.items():
        a = np.asarray(value)
        if leaf == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            else:
                a = a.T[..., None] if conv1d else a.T
            sd[f"{name}.weight"] = _t(a)
        elif leaf == "scale":
            sd[f"{name}.weight"] = _t(a)
        elif leaf == "bias":
            sd[f"{name}.bias"] = _t(a)
        else:
            raise KeyError(f"unexpected flax leaf {name}/{leaf}")


# torch path segments that hold an underscore (openaimodel, attention.py, spade.py)
_MULTI = {"in_layers", "emb_layers", "out_layers", "skip_connection", "mlp_shared", "mlp_gamma",
          "mlp_beta", "proj_in", "proj_out", "transformer_blocks", "to_q", "to_k", "to_v",
          "to_out", "param_free_norm"}


def _dotted(inner: str) -> str:
    """``transformer_blocks_0_attn1_to_q`` -> ``transformer_blocks.0.attn1.to_q``."""
    tokens, out, i = inner.split("_"), [], 0
    while i < len(tokens):
        for width in (3, 2, 1):
            seg = "_".join(tokens[i:i + width])
            if width == 1 or seg in _MULTI:
                out.append(seg)
                i += width
                break
    return ".".join(out)


def _openai_unet(params: dict) -> dict:
    """UNetModelDualcondV2 / EncoderUNetModelWT: the inverse of
    ssl_tpu.utils.weight_port._sd_openai_unet_tree."""
    sd: dict = {}
    for top, node in params.items():
        m = re.fullmatch(r"(input_blocks|output_blocks)_(\d+)_(\d+)", top) or \
            re.fullmatch(r"(middle_block|time_embed|out|fea_tran)_(\d+)", top)
        if m is None:
            raise KeyError(f"unexpected flax module {top}")
        base = ".".join(m.groups())
        if "kernel" in node or "scale" in node:
            _leaves(sd, base, node)
            continue
        for inner, leaf in node.items():
            # AttentionBlockQKV's qkv and proj_out are kernel-1 Conv1d layers in torch
            _leaves(sd, f"{base}.{_dotted(inner)}", leaf,
                    conv1d="qkv" in node and inner in ("qkv", "proj_out"))
    return sd


_VAE_RESNET = {"GroupNorm_0": "norm1", "Conv_0": "conv1", "GroupNorm_1": "norm2",
               "Conv_1": "conv2", "Conv_2": "nin_shortcut"}


def _ldm_vae(params: dict) -> dict:
    """AutoencoderKL: the inverse of ssl_tpu.utils.weight_port.convert_ldm_vae."""
    sd: dict = {}
    for name in ("quant_conv", "post_quant_conv"):
        _leaves(sd, name, params[name])
    for coder in ("encoder", "decoder"):
        for key, node in params[coder].items():
            path = (key.replace("mid_block_", "mid.block_").replace("mid_attn", "mid.attn_1"))
            path = re.sub(r"^(down|up)_(\d+)_block_(\d+)$", r"\1.\2.block.\3", path)
            path = re.sub(r"^(down|up)_(\d+)_(downsample|upsample)$", r"\1.\2.\3.conv", path)
            base = f"{coder}.{path}"
            if "kernel" in node or "scale" in node:
                _leaves(sd, base, node)
                continue
            attn = key == "mid_attn"
            for inner, leaf in node.items():
                sub = "norm" if attn and inner == "GroupNorm_0" else _VAE_RESNET.get(inner, inner)
                _leaves(sd, f"{base}.{sub}", leaf)
    return sd


def params_from_jax(family: str, params: dict, batch_stats: dict | None = None):
    """State dict for the port's ``family`` module from a flax params tree.
    ``StableSRSSL`` takes the diffusion params dict {'unet', 'structcond',
    'null_context'} and returns the same keys: two state dicts and a tensor."""
    if family in ("UNetModelDualcondV2", "EncoderUNetModelWT"):
        return _openai_unet(params)
    if family == "AutoencoderKL":
        return _ldm_vae(params)
    if family == "StableSRSSL":
        return {"unet": _openai_unet(params["unet"]),
                "structcond": _openai_unet(params["structcond"]),
                "null_context": _t(params["null_context"])}
    if family == "RRDBNet":
        return _rrdbnet(params)
    if family == "VGGStyleDiscriminator":
        return _vgg_disc(params, batch_stats)
    if family == "UNetDiscriminatorSN":
        return _unet_disc(params, batch_stats)
    if family == "VGGFeatureExtractor":
        return _vgg_features(params)
    raise KeyError(f"no weight carry for {family!r}; known: {FAMILIES}")
