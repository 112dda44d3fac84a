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
families load strictly).  ``params_to_jax`` goes the other way for the
diffusion training checkpoint (the UNet, the struct-cond encoder and the
null context) and the CFW autoencoder, so the port writes the pickles the
JAX CLIs write.

``load_reference_state`` loads a reference-layout (SD / ldm / StableSR)
state dict into one of the diffusion nets by its own keys, with the JAX
package's merge semantics (``convert_ldm_vae`` / ``convert_sd_unet`` /
``convert_sd_structcond`` and ``merge_into_tree``).

The diffusion families name their torch modules as StableSR and ldm do; the
flax names encode those paths (``input_blocks_1_0`` / ``in_layers_2`` is
``input_blocks.1.0.in_layers.2``, ``down_0_block_1`` / ``GroupNorm_0`` is
``down.0.block.1.norm1``), and the maps below undo the encoding."""

from __future__ import annotations

import re

import numpy as np
import torch

FAMILIES = ("RRDBNet", "VGGStyleDiscriminator", "UNetDiscriminatorSN", "VGGFeatureExtractor",
            "RRDBBebyGANNet", "BSRGANRRDBNet", "SPSRNet", "RankSRGANSRResNet",
            "Discriminator_VGG_296", "Ranker_VGG12_296", "SwinIR", "ELAN",
            "MSRResNet", "KAIRMSRResNet0", "KAIRDiscriminatorVGG96", "KAIRDiscriminatorVGG128",
            "KAIRDiscriminatorVGG192", "KAIRDiscriminatorVGG128SN", "KAIRDiscriminatorPatchGAN",
            "SRVGGNetCompact", "EDSR", "RCAN", "ECBSR",
            "UNetModelDualcondV2",
            "EncoderUNetModelWT", "AutoencoderKL", "StableSRSSL",
            "LPIPSAlex", "DISTS", "InceptionV3FID", "CLIPRN50",
            "UNetDiscriminatorSNv1", "MOD", "Discriminator_VGG_192", "DiscriminatorSN_VGG_192",
            "NLayerDiscriminator", "RRDBPSNet", "RRDBMeanNet", "AutoencoderKLResi")


def load_torch_state_dict(path: str, param_key: str = "params") -> dict:
    """A checkpoint's state dict, read with ``weights_only=True``: the
    ``param_key`` entry where the file holds one (else ``params``, else
    ``params_ema``, else the file itself), DDP's ``module.`` prefixes
    dropped (reference base_model.py:289-315)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and param_key in sd:
        sd = sd[param_key]
    elif isinstance(sd, dict) and "params_ema" in sd and param_key == "params":
        sd = sd.get("params", sd["params_ema"])
    if isinstance(sd, dict) and sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return sd


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


def _rrdb(sd: dict, name: str, node: dict, index=None) -> None:
    """One RRDB (three dense blocks of five convs) under ``name``."""
    for j in range(3):
        for kk in range(5):
            leaf = node[f"ResidualDenseBlock_{j}"][f"Conv3x3_{kk}"]["Conv_0"]
            _conv(sd, f"{name}.rdb{j + 1}.conv{kk + 1}", leaf, index)


def _count(params: dict, prefix: str) -> int:
    return sum(1 for k in params if re.fullmatch(rf"{prefix}\d+", k))


def _rrdbnet(params: dict) -> dict:
    sd: dict = {}
    for name in ("conv_first", "conv_body", "conv_up1", "conv_up2", "conv_hr", "conv_last"):
        _conv(sd, name, params[name])
    body = params.get("body")
    if body is not None:  # scanned trunk: leaves stacked on a leading block axis
        cell = body["RRDB_0"]
        n_blocks = np.asarray(
            cell["ResidualDenseBlock_0"]["Conv3x3_0"]["Conv_0"]["kernel"]).shape[0]
        for i in range(n_blocks):
            _rrdb(sd, f"body.{i}", cell, i)
    else:
        for i in range(_count(params, "body_")):
            _rrdb(sd, f"body.{i}", params[f"body_{i}"])
    return sd


def _rrdb_trunk(params: dict) -> dict:
    """RRDBBebyGANNet / BSRGANRRDBNet (the flax tree under ``net``)."""
    params, sd = params["net"], {}
    for name in ("conv_first", "trunk_conv", "upconv1", "upconv2", "HRconv", "conv_last"):
        if name in params:
            _conv(sd, name, params[name])
    for i in range(_count(params, "body_")):
        _rrdb(sd, f"body.{i}", params[f"body_{i}"])
    return sd


def _spsr(params: dict) -> dict:
    sd: dict = {}
    for name, node in params.items():
        m = re.fullmatch(r"(rb|b_block|b_concat|up|b_up)_(\d+)", name)
        if m:  # flax numbers the branch's blocks from 1, torch's lists from 0
            base = f"{m[1]}.{int(m[2]) - (m[1] in ('b_block', 'b_concat'))}"
        else:
            base = name
        if name.startswith(("rb_", "b_block_")) or name == "f_block":
            _rrdb(sd, base, node)
        else:
            _conv(sd, base, node.get("Conv_0", node))
    return sd


def _ranksrgan_g(params: dict) -> dict:
    sd: dict = {}
    for name, node in params.items():
        if name.startswith("trunk_"):
            i = name[len("trunk_"):]
            _conv(sd, f"recon_trunk.{i}.conv1", node["Conv3x3_0"]["Conv_0"])
            _conv(sd, f"recon_trunk.{i}.conv2", node["Conv3x3_1"]["Conv_0"])
        else:
            _conv(sd, name, node)
    return sd


def _ranker(params: dict, batch_stats: dict | None) -> dict:
    sd: dict = {}
    for name, node in params.items():
        _leaves(sd, name, node)
        if batch_stats is not None and name in batch_stats:
            st = batch_stats[name]
            sd[f"{name}.running_mean"], sd[f"{name}.running_var"] = _t(st["mean"]), _t(st["var"])
    return sd


def _linear(sd: dict, name: str, node: dict, index=None) -> None:
    """A flax Dense, or a 1x1 Conv, into a torch Linear; ``index`` picks one
    layer of stacked leaves."""
    def leaf(key):
        a = np.asarray(node[key])
        return a[index] if index is not None else a
    k = leaf("kernel")
    sd[f"{name}.weight"] = _t((k[0, 0] if k.ndim == 4 else k).T)
    sd[f"{name}.bias"] = _t(leaf("bias"))


def _norm(sd: dict, name: str, node: dict, index=None) -> None:
    for leaf, key in (("scale", "weight"), ("bias", "bias")):
        a = np.asarray(node[leaf])
        sd[f"{name}.{key}"] = _t(a[index] if index is not None else a)


def _swin_block(sd: dict, name: str, node: dict, index=None) -> None:
    attn = node["WindowAttention_0"]
    _norm(sd, f"{name}.norm1", node["LayerNorm_0"], index)
    _linear(sd, f"{name}.attn.qkv", attn["qkv"], index)
    _linear(sd, f"{name}.attn.proj", attn["proj"], index)
    table = np.asarray(attn["rel_pos_bias"])
    sd[f"{name}.attn.relative_position_bias_table"] = _t(table[index] if index is not None
                                                         else table)
    _norm(sd, f"{name}.norm2", node["LayerNorm_1"], index)
    _linear(sd, f"{name}.mlp.fc1", node["Dense_0"], index)
    _linear(sd, f"{name}.mlp.fc2", node["Dense_1"], index)


def _swinir(params: dict) -> dict:
    """SwinIR; an RSTB scanned in (no-shift, shift) pairs holds its blocks'
    leaves stacked (depth // 2, ...) under ``pairs``: pair p is blocks 2p
    and 2p + 1."""
    sd: dict = {}
    upsample = sorted((k for k in params if re.fullmatch(r"Conv_\d+", k)),
                      key=lambda k: int(k[5:]))
    for k, name in enumerate(upsample):          # conv, pixel shuffle, conv, ...
        _conv(sd, f"upsample.{2 * k}", params[name])
    for name, node in params.items():
        if name in upsample:
            continue
        if name == "patch_embed_norm":
            _norm(sd, "patch_embed.norm", node)
        elif name == "norm":
            _norm(sd, "norm", node)
        elif name == "conv_before_upsample":
            _conv(sd, "conv_before_upsample.0", node)
        elif name.startswith("layer_"):
            base = f"layers.{name[len('layer_'):]}"
            _conv(sd, f"{base}.conv", node["conv"])
            if "pairs" in node:
                cells = node["pairs"]
                n = np.asarray(cells["SwinBlock_0"]["WindowAttention_0"]["rel_pos_bias"]).shape[0]
                for p in range(n):
                    for j in (0, 1):
                        _swin_block(sd, f"{base}.residual_group.blocks.{2 * p + j}",
                                    cells[f"SwinBlock_{j}"], p)
            else:
                for j in range(_count(node, "block_")):
                    _swin_block(sd, f"{base}.residual_group.blocks.{j}", node[f"block_{j}"])
        else:
            _conv(sd, name, node)
    return sd


def _elan(params: dict) -> dict:
    sd: dict = {}
    for name in ("head", "tail"):
        _conv(sd, name, params[name])
    for i in range(_count(params, "body_")):
        block = params[f"body_{i}"]
        for j in range(_count(block, "lfe_")):
            lfe, gmsa, base = block[f"lfe_{j}"], block[f"gmsa_{j}"], f"body.{i}"
            _linear(sd, f"{base}.lfe.{j}.conv0.conv", lfe["ShiftConv_0"]["Conv_0"])
            _linear(sd, f"{base}.lfe.{j}.conv1.conv", lfe["ShiftConv_1"]["Conv_0"])
            _linear(sd, f"{base}.gmsa.{j}.project_inp", gmsa["Conv_0"])
            _norm(sd, f"{base}.gmsa.{j}.norm", gmsa["LayerNorm_0"])
            _linear(sd, f"{base}.gmsa.{j}.project_out", gmsa["Conv_1"])
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
    _nhwc_head(sd, params, np.asarray(params[f"Conv_{n_conv - 1}"]["kernel"]).shape[-1])
    return sd


def _nhwc_head(sd: dict, params: dict, c: int) -> None:
    """``Dense_0`` / ``Dense_1`` -> ``linear1`` / ``linear2``.  The flax
    head flattens an NHWC (s, s, c) map, torch an NCHW one: ``linear1``'s
    columns are reordered."""
    k = np.asarray(params["Dense_0"]["kernel"])            # (s*s*c, 100)
    s = int(round((k.shape[0] // c) ** 0.5))
    k = k.reshape(s, s, c, -1).transpose(3, 2, 0, 1).reshape(k.shape[-1], -1)
    sd["linear1.weight"], sd["linear1.bias"] = _t(k), _t(params["Dense_0"]["bias"])
    _linear(sd, "linear2", params["Dense_1"])


def _vgg192_sn(params: dict, batch_stats: dict | None) -> dict:
    """DiscriminatorSN_VGG_192: ``Conv_0`` is ``conv0_0``; ``_SNConv_{k}``
    are ``conv0_1``, ``conv1_0``, ``conv1_1``, ... ``conv5_1`` in order."""
    sd: dict = {}
    _conv(sd, "conv0_0", params["Conv_0"])
    names = ["conv0_1"] + [f"conv{i}_{j}" for i in range(1, 6) for j in (0, 1)]
    for k, name in enumerate(names):
        _conv(sd, name, params[f"_SNConv_{k}"]["Conv_0"])
        if batch_stats is not None:
            sn = batch_stats[f"_SNConv_{k}"]["SpectralNorm_0"]
            sd[f"{name}.u"] = _t(sn["Conv_0/kernel/u"])
            sd[f"{name}.sigma"] = _t(sn["Conv_0/kernel/sigma"])
    c = np.asarray(params[f"_SNConv_{len(names) - 1}"]["Conv_0"]["kernel"]).shape[-1]
    _nhwc_head(sd, params, c)
    return sd


def _mod(params: dict, batch_stats: dict | None) -> dict:
    """MOD: the names are the same on both sides; the gating and transform
    weights are parameters of their own."""
    sd: dict = {}
    for name, node in params.items():
        if name.startswith("fe_conv"):
            _conv(sd, name, node)
        elif name.startswith("fe_bn"):
            _bn(sd, name, node, None if batch_stats is None else batch_stats[name])
        elif name in ("cr_body", "cls_fc1", "cls_fc2"):
            _linear(sd, name, node)
        else:                                              # w_gating1, cr_weight
            sd[name] = _t(node)
    return sd


def _nlayer_d(params: dict, batch_stats: dict | None) -> dict:
    """NLayerDiscriminator: ``conv*`` as named; ``BatchNorm_{k}`` is ``bn{k + 1}``."""
    sd: dict = {}
    for name, node in params.items():
        if name.startswith("BatchNorm_"):
            _bn(sd, f"bn{int(name.split('_')[1]) + 1}", node,
                None if batch_stats is None else batch_stats[name])
        else:
            _conv(sd, name, node)
    return sd


def _rrdbps(params: dict) -> dict:
    """RRDBPSNet: RRDBNet's unscanned trunk and a pixel-shuffle ``upsample``."""
    sd: dict = {}
    for name in ("conv_first", "conv_body", "conv_hr", "conv_last"):
        _conv(sd, name, params[name])
    for i in range(_count(params, "body_")):
        _rrdb(sd, f"body.{i}", params[f"body_{i}"])
    _upsample(sd, params["upsample"])
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


def _sn_stats(sd: dict, name: str, stats: dict | None, leaf: str) -> None:
    """A spectral norm's ``u`` and ``sigma`` (flax keeps them in batch_stats
    under ``SpectralNorm_0`` as ``{leaf}/kernel/u`` and ``.../sigma``)."""
    if stats is not None and name in stats:
        sn = stats[name]["SpectralNorm_0"]
        sd[f"{name}.u"] = _t(sn[f"{leaf}/kernel/u"])
        sd[f"{name}.sigma"] = _t(sn[f"{leaf}/kernel/sigma"])


def _bn(sd: dict, name: str, node: dict, stats: dict | None) -> None:
    sd[f"{name}.weight"], sd[f"{name}.bias"] = _t(node["scale"]), _t(node["bias"])
    if stats is not None:
        sd[f"{name}.running_mean"], sd[f"{name}.running_var"] = _t(stats["mean"]), _t(stats["var"])


def _resblocks(sd: dict, params: dict, prefix: str = "body") -> None:
    """ResidualBlockNoBN's ``{prefix}_{i}/Conv3x3_{j}/Conv_0`` ->
    ``{prefix}.{i}.conv{j + 1}``."""
    for name, node in params.items():
        if re.fullmatch(rf"{prefix}_\d+", name):
            i = name.split("_")[-1]
            for j in (0, 1):
                _conv(sd, f"{prefix}.{i}.conv{j + 1}", node[f"Conv3x3_{j}"]["Conv_0"])


def _msrresnet(params: dict) -> dict:
    sd: dict = {}
    for name in ("conv_first", "upconv1", "upconv2", "conv_hr", "conv_last"):
        if name in params:
            _conv(sd, name, params[name])
    _resblocks(sd, params)
    return sd


def _kair_msrresnet0(params: dict) -> dict:
    sd: dict = {}
    for name, node in params.items():
        m = re.fullmatch(r"b(\d+)_conv(\d)", name) or re.fullmatch(r"up(\d+)", name)
        if m is None:
            _conv(sd, name, node)
        elif name.startswith("up"):
            _conv(sd, f"ups.{m[1]}", node)
        else:
            _conv(sd, f"blocks.{m[1]}.conv{m[2]}", node)
    return sd


def _kair_vgg_d(params: dict, batch_stats: dict | None) -> dict:
    """The KAIR VGG discriminators: ``_KAIRVGGFeatures_0``'s ``Conv_{k}`` and
    ``BatchNorm_{k}``; the head flattens NCHW in both, so no reorder."""
    sd: dict = {}
    feats = params["_KAIRVGGFeatures_0"]
    stats = None if batch_stats is None else batch_stats["_KAIRVGGFeatures_0"]
    for name, node in feats.items():
        kind, k = name.rsplit("_", 1)
        if kind == "Conv":
            _conv(sd, f"convs.{k}", node)
        else:
            _bn(sd, f"bns.{k}", node, None if stats is None else stats[name])
    _linear(sd, "linear0", params["Dense_0"])
    _linear(sd, "linear1", params["Dense_1"])
    return sd


def _kair_vgg128_sn(params: dict, batch_stats: dict | None) -> dict:
    sd: dict = {}
    for name, node in params.items():
        if name.startswith("conv"):
            _conv(sd, name, node["Conv_0"])
            _sn_stats(sd, name, batch_stats, "Conv_0")
        else:
            _linear(sd, name, node["Dense_0"])
            _sn_stats(sd, name, batch_stats, "Dense_0")
    return sd


def _kair_patchgan(params: dict, batch_stats: dict | None) -> dict:
    sd: dict = {}
    for name, node in params.items():
        if name.startswith("child"):
            _conv(sd, name, node.get("Conv_0", node))
            _sn_stats(sd, name, batch_stats, "Conv_0")
        else:
            _bn(sd, f"bns.{name.rsplit('_', 1)[1]}", node,
                None if batch_stats is None else batch_stats[name])
    return sd


def _srvgg(params: dict) -> dict:
    """``conv_first`` / ``act_first`` / ``conv_{i}`` / ``act_{i}`` /
    ``conv_last`` -> the reference's alternating ``body.{k}``."""
    sd: dict = {}
    n_conv = _count(params, "conv_")
    _conv(sd, "body.0", params["conv_first"])
    for i in range(n_conv):
        _conv(sd, f"body.{2 * i + 2}", params[f"conv_{i}"])
    _conv(sd, f"body.{2 * n_conv + 2}", params["conv_last"])
    for name, node in params.items():
        if name.startswith("act_"):
            k = 1 if name == "act_first" else 2 * int(name[len("act_"):]) + 3
            sd[f"body.{k}.weight"] = _t(node["alpha"])
    return sd


def _upsample(sd: dict, node: dict) -> None:
    for name, leaf in node.items():         # Conv_{j} -> upsample.{2 j}
        _conv(sd, f"upsample.{2 * int(name.split('_')[1])}", leaf)


def _edsr(params: dict) -> dict:
    sd: dict = {}
    for name in ("conv_first", "conv_after_body", "conv_last"):
        _conv(sd, name, params[name])
    _resblocks(sd, params)
    _upsample(sd, params["upsample"])
    return sd


def _rcan(params: dict) -> dict:
    sd: dict = {}
    for name in ("conv_first", "conv_after_body", "conv_last"):
        _conv(sd, name, params[name])
    _upsample(sd, params["upsample"])
    for name, group in params.items():
        if not name.startswith("group_"):
            continue
        g = f"body.{name.split('_')[1]}"
        _conv(sd, f"{g}.conv", group["conv"])
        for bname, block in group.items():
            if bname.startswith("rcab_"):
                b = f"{g}.residual_group.{bname.split('_')[1]}.rcab"
                _conv(sd, f"{b}.0", block["conv1"])
                _conv(sd, f"{b}.2", block["conv2"])
                _conv(sd, f"{b}.3.attention.1", block["ca"]["down"])
                _conv(sd, f"{b}.3.attention.3", block["ca"]["up"])
    return sd


def _ecbsr(params: dict) -> dict:
    sd: dict = {}
    for name, block in params.items():
        base = f"backbone.{name.split('_')[1]}"
        _conv(sd, f"{base}.conv3x3", block["conv3x3"])
        for br, node in block.items():
            if not br.startswith("conv1x1"):
                continue
            sd[f"{base}.{br}.k0"] = _t(np.asarray(node["conv0_w"]["kernel"]).transpose(3, 2, 0, 1))
            sd[f"{base}.{br}.b0"] = _t(node["b0_pad"])
            if "conv1" in node:
                sd[f"{base}.{br}.k1"] = _t(np.asarray(node["conv1"]["kernel"]).transpose(3, 2, 0, 1))
                sd[f"{base}.{br}.b1"] = _t(node["conv1"]["bias"])
            else:
                sd[f"{base}.{br}.scale"] = _t(np.asarray(node["scale"]).reshape(-1, 1, 1, 1))
                sd[f"{base}.{br}.bias"] = _t(node["bias"])
        if "act" in block:
            sd[f"{base}.act.weight"] = _t(block["act"]["alpha"])
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
# a fuse block's bracketing ResBlocks (ldm model.py:797) name their skip conv_out
_FUSE_RESBLOCK = {**_VAE_RESNET, "Conv_2": "conv_out"}


def _ldm_vae(params: dict) -> dict:
    """AutoencoderKL and AutoencoderKLResi: the inverse of
    ssl_tpu.utils.weight_port.convert_ldm_vae."""
    sd: dict = {}
    for name in ("quant_conv", "post_quant_conv"):
        _leaves(sd, name, params[name])
    for coder in ("encoder", "decoder"):
        for key, node in params[coder].items():
            if key.startswith("fusion_layer_"):
                for inner, sub in node.items():
                    base = f"{coder}.{key}"
                    if inner.startswith("encode_enc_2_"):     # the RRDB trunk
                        _rrdb(sd, f"{base}.encode_enc_2.{inner.rsplit('_', 1)[1]}", sub)
                    else:
                        for leaf_name, leaf in sub.items():
                            _leaves(sd, f"{base}.{inner}.{_FUSE_RESBLOCK[leaf_name]}", leaf)
                continue
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


def _lpips(params: dict) -> dict:
    sd: dict = {}
    for name, node in params["net"].items():
        _conv(sd, f"net.{name}", node)
    for i in range(5):
        sd[f"lin{i}"] = _t(params[f"lin{i}"])
    return sd


def _dists(params: dict) -> dict:
    sd = {"alpha": _t(params["alpha"]), "beta": _t(params["beta"])}
    for name, node in params["vgg16"].items():
        _conv(sd, f"vgg16.{name}", node)
    return sd


# torchvision inception_v3's module and branch names, in the call order that
# names the flax modules of ssl_tpu/metrics/fid.py (``_BasicConv_{i}`` in a
# block, ``_Inception{A..E}_{i}`` at the top); as ssl_tpu/utils/weight_port.py's
_FID_STEM = ["Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
             "Conv2d_3b_1x1", "Conv2d_4a_3x3"]
_FID_BRANCHES = {
    "A": ["branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1", "branch3x3dbl_2",
          "branch3x3dbl_3", "branch_pool"],
    "B": ["branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"],
    "C": ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3", "branch7x7dbl_1",
          "branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"],
    "D": ["branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3",
          "branch7x7x3_4"],
    "E": ["branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b", "branch3x3dbl_1",
          "branch3x3dbl_2", "branch3x3dbl_3a", "branch3x3dbl_3b", "branch_pool"],
}
_FID_BLOCKS = [("Mixed_5b", "_InceptionA_0"), ("Mixed_5c", "_InceptionA_1"),
               ("Mixed_5d", "_InceptionA_2"), ("Mixed_6a", "_InceptionB_0"),
               ("Mixed_6b", "_InceptionC_0"), ("Mixed_6c", "_InceptionC_1"),
               ("Mixed_6d", "_InceptionC_2"), ("Mixed_6e", "_InceptionC_3"),
               ("Mixed_7a", "_InceptionD_0"), ("Mixed_7b", "_InceptionE_0"),
               ("Mixed_7c", "_InceptionE_1")]


def _fid_inception(params: dict, batch_stats: dict) -> dict:
    """InceptionV3FID: the inverse of ssl_tpu.utils.weight_port.convert_fid_inception."""
    sd: dict = {}

    def basic(name: str, node: dict, stats: dict) -> None:
        _conv(sd, f"{name}.conv", node["Conv_0"])
        _bn(sd, f"{name}.bn", node["BatchNorm_0"], stats["BatchNorm_0"])

    for i, name in enumerate(_FID_STEM):
        basic(name, params[f"_BasicConv_{i}"], batch_stats[f"_BasicConv_{i}"])
    for block, flax_block in _FID_BLOCKS:
        kind = flax_block[len("_Inception")]
        for bi, branch in enumerate(_FID_BRANCHES[kind]):
            basic(f"{block}.{branch}", params[flax_block][f"_BasicConv_{bi}"],
                  batch_stats[flax_block][f"_BasicConv_{bi}"])
    return sd


def _clip_rn50(params: dict, batch_stats: dict) -> dict:
    """CLIP RN50 in OpenAI's layout from ``{"visual": ..., "text": ...}``
    (the inverse of ssl_tpu.utils.weight_port.convert_clip_rn50) and the
    visual ``batch_stats``; the flax text attention's fused ``in_proj`` is
    ``in_proj_weight`` (3C, C)."""
    vis, text = params["visual"], params["text"]
    sd: dict = {}

    for n in (1, 2, 3):
        _conv(sd, f"visual.conv{n}", vis[f"conv{n}"])
        _bn(sd, f"visual.bn{n}", vis[f"bn{n}"], batch_stats[f"bn{n}"])
    for name, node in vis.items():
        m = re.fullmatch(r"layer(\d)_(\d+)", name)
        if m is None:
            continue
        base, stats = f"visual.layer{m.group(1)}.{m.group(2)}", batch_stats[name]
        for c in (1, 2, 3):
            _conv(sd, f"{base}.conv{c}", node[f"conv{c}"])
            _bn(sd, f"{base}.bn{c}", node[f"bn{c}"], stats[f"bn{c}"])
        if "downsample_conv" in node:
            _conv(sd, f"{base}.downsample.0", node["downsample_conv"])
            _bn(sd, f"{base}.downsample.1", node["downsample_bn"], stats["downsample_bn"])
    ap = vis["attnpool"]
    sd["visual.attnpool.positional_embedding"] = _t(ap["positional_embedding"])
    for n in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _linear(sd, f"visual.attnpool.{n}", ap[n])
    sd["token_embedding.weight"] = _t(text["token_embedding"]["embedding"])
    sd["positional_embedding"] = _t(text["positional_embedding"])
    _norm(sd, "ln_final", text["ln_final"])
    sd["text_projection"] = _t(text["text_projection"])
    i = 0
    while f"resblock_{i}" in text:
        blk, base = text[f"resblock_{i}"], f"transformer.resblocks.{i}"
        _norm(sd, f"{base}.ln_1", blk["ln_1"])
        sd[f"{base}.attn.in_proj_weight"] = _t(np.asarray(blk["in_proj"]["kernel"]).T)
        sd[f"{base}.attn.in_proj_bias"] = _t(blk["in_proj"]["bias"])
        _linear(sd, f"{base}.attn.out_proj", blk["out_proj"])
        _norm(sd, f"{base}.ln_2", blk["ln_2"])
        _linear(sd, f"{base}.mlp.c_fc", blk["c_fc"])
        _linear(sd, f"{base}.mlp.c_proj", blk["c_proj"])
        i += 1
    return sd


def params_from_jax(family: str, params: dict, batch_stats: dict | None = None):
    """State dict for the port's ``family`` module from a flax params tree.
    ``StableSRSSL`` takes the diffusion params dict {'unet', 'structcond',
    'null_context'} and returns the same keys: two state dicts and a tensor."""
    if family in ("UNetModelDualcondV2", "EncoderUNetModelWT"):
        return _openai_unet(params)
    if family in ("AutoencoderKL", "AutoencoderKLResi"):
        return _ldm_vae(params)
    if family == "StableSRSSL":
        return {"unet": _openai_unet(params["unet"]),
                "structcond": _openai_unet(params["structcond"]),
                "null_context": _t(params["null_context"])}
    if family in ("RRDBNet", "RRDBMeanNet"):
        return _rrdbnet(params)
    if family == "RRDBPSNet":
        return _rrdbps(params)
    if family in ("VGGStyleDiscriminator", "Discriminator_VGG_192"):
        return _vgg_disc(params, batch_stats)
    if family == "DiscriminatorSN_VGG_192":
        return _vgg192_sn(params, batch_stats)
    if family == "MOD":
        return _mod(params, batch_stats)
    if family == "NLayerDiscriminator":
        return _nlayer_d(params, batch_stats)
    if family == "Discriminator_VGG_296":   # the stack is a submodule in flax
        stack = "_VGGDownStack_0"
        return _vgg_disc({**params[stack], "Dense_0": params["Dense_0"],
                          "Dense_1": params["Dense_1"]},
                         None if batch_stats is None else batch_stats[stack])
    if family in ("RRDBBebyGANNet", "BSRGANRRDBNet"):
        return _rrdb_trunk(params)
    if family == "SPSRNet":
        return _spsr(params)
    if family == "RankSRGANSRResNet":
        return _ranksrgan_g(params)
    if family == "Ranker_VGG12_296":
        return _ranker(params, batch_stats)
    if family == "SwinIR":
        return _swinir(params)
    if family == "ELAN":
        return _elan(params)
    if family in ("UNetDiscriminatorSN", "UNetDiscriminatorSNv1"):
        return _unet_disc(params, batch_stats)
    if family == "MSRResNet":
        return _msrresnet(params)
    if family == "KAIRMSRResNet0":
        return _kair_msrresnet0(params)
    if family in ("KAIRDiscriminatorVGG96", "KAIRDiscriminatorVGG128", "KAIRDiscriminatorVGG192"):
        return _kair_vgg_d(params, batch_stats)
    if family == "KAIRDiscriminatorVGG128SN":
        return _kair_vgg128_sn(params, batch_stats)
    if family == "KAIRDiscriminatorPatchGAN":
        return _kair_patchgan(params, batch_stats)
    if family == "SRVGGNetCompact":
        return _srvgg(params)
    if family == "EDSR":
        return _edsr(params)
    if family == "RCAN":
        return _rcan(params)
    if family == "ECBSR":
        return _ecbsr(params)
    if family == "VGGFeatureExtractor":
        return _vgg_features(params)
    if family == "LPIPSAlex":
        return _lpips(params)
    if family == "DISTS":
        return _dists(params)
    if family == "InceptionV3FID":
        return _fid_inception(params, batch_stats)
    if family == "CLIPRN50":
        return _clip_rn50(params, batch_stats)
    raise KeyError(f"no weight carry for {family!r}; known: {FAMILIES}")


def _openai_unet_to_jax(sd: dict) -> dict:
    """The inverse of ``_openai_unet``: ``input_blocks.1.0.in_layers.2.weight``
    -> ``input_blocks_1_0`` / ``in_layers_2`` / ``kernel``; a 4-d weight is an
    OIHW conv (-> HWIO), a 3-d one a kernel-1 Conv1d and a 2-d one a Linear
    (-> (in, out)), a 1-d one a norm's scale."""
    tree: dict = {}
    for key, value in sd.items():
        a = value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)
        *modules, leaf = unet_flax_path(key, a.ndim)
        node = tree
        for name in modules:
            node = node.setdefault(name, {})
        node[leaf] = (a.transpose(2, 3, 1, 0) if a.ndim == 4 else a[..., 0].T if a.ndim == 3
                      else a.T if a.ndim == 2 else a)
    return _np_leaves(tree)


def unet_flax_path(key: str, ndim: int) -> list[str]:
    """The flax path of the UNet (or struct-cond encoder) parameter ``key``
    of ``ndim`` dims: ``input_blocks.1.0.in_layers.2.weight`` ->
    [``input_blocks_1_0``, ``in_layers_2``, ``kernel``] (a 1-d weight is a
    norm's ``scale``)."""
    m = re.fullmatch(r"(input_blocks|output_blocks)\.(\d+)\.(\d+)\.(.+)", key) or \
        re.fullmatch(r"(middle_block|time_embed|out|fea_tran)\.(\d+)\.(.+)", key)
    if m is None:
        raise KeyError(f"unexpected torch parameter {key}")
    *head, rest = m.groups()
    path, leaf = rest.rsplit(".", 1) if "." in rest else ("", rest)
    if leaf not in ("weight", "bias"):
        raise KeyError(f"unexpected torch leaf {key}")
    leaf = "bias" if leaf == "bias" else "scale" if ndim == 1 else "kernel"
    return ["_".join(head)] + ([path.replace(".", "_")] if path else []) + [leaf]


def _np_leaves(tree):
    """Every leaf a C-contiguous float32 numpy array, as ``jax.device_get``
    gives a float32 params tree."""
    if isinstance(tree, dict):
        return {k: _np_leaves(v) for k, v in tree.items()}
    return np.ascontiguousarray(tree, dtype=np.float32)


_VAE_TO_FLAX = {v: k for k, v in _FUSE_RESBLOCK.items()} | {"nin_shortcut": "Conv_2"}


def vae_flax_path(key: str) -> list[str]:
    """The flax path of the port's VAE parameter ``key`` (AutoencoderKL or
    AutoencoderKLResi), without the leaf: ``decoder.up.2.block.0.norm1`` ->
    [``decoder``, ``up_2_block_0``, ``GroupNorm_0``]; the inverse of
    ``_ldm_vae``'s names."""
    path = key.rsplit(".", 1)[0]
    rules = (
        (r"decoder\.(fusion_layer_\d+)\.encode_enc_2\.(\d+)\.rdb(\d)\.conv(\d)",
         lambda m: ["decoder", m[1], f"encode_enc_2_{m[2]}",
                    f"ResidualDenseBlock_{int(m[3]) - 1}", f"Conv3x3_{int(m[4]) - 1}", "Conv_0"]),
        (r"decoder\.(fusion_layer_\d+)\.(encode_enc_[13])\.(\w+)",
         lambda m: ["decoder", m[1], m[2], _VAE_TO_FLAX[m[3]]]),
        (r"(encoder|decoder)\.mid\.attn_1\.(\w+)",
         lambda m: [m[1], "mid_attn", "GroupNorm_0" if m[2] == "norm" else m[2]]),
        (r"(encoder|decoder)\.mid\.(block_\d)\.(\w+)",
         lambda m: [m[1], f"mid_{m[2]}", _VAE_TO_FLAX[m[3]]]),
        (r"(encoder|decoder)\.(down|up)\.(\d+)\.block\.(\d+)\.(\w+)",
         lambda m: [m[1], f"{m[2]}_{m[3]}_block_{m[4]}", _VAE_TO_FLAX[m[5]]]),
        (r"(encoder|decoder)\.(down|up)\.(\d+)\.(downsample|upsample)\.conv",
         lambda m: [m[1], f"{m[2]}_{m[3]}_{m[4]}"]),
        (r"(encoder|decoder)\.(conv_in|conv_out|norm_out)", lambda m: [m[1], m[2]]),
        (r"(quant_conv|post_quant_conv)", lambda m: [m[1]]))
    for pattern, to_path in rules:
        m = re.fullmatch(pattern, path)
        if m:
            return to_path(m)
    raise KeyError(f"unexpected VAE parameter {key}")


def _ldm_vae_to_jax(sd: dict) -> dict:
    """The inverse of ``_ldm_vae``: OIHW -> HWIO, a 1-d weight a norm's scale."""
    tree: dict = {}
    for key, value in sd.items():
        a = value.detach().cpu().numpy()
        node = tree
        for name in vae_flax_path(key):
            node = node.setdefault(name, {})
        leaf = "bias" if key.endswith(".bias") else "scale" if a.ndim == 1 else "kernel"
        node[leaf] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    return _np_leaves(tree)


def params_to_jax(family: str, params) -> dict:
    """The flax params tree of the port's ``family`` weights, numpy leaves in
    flax's layout; the inverse of ``params_from_jax`` for the diffusion
    families.  ``StableSRSSL`` takes {'unet', 'structcond', 'null_context'}
    (modules or state dicts, and a tensor) and returns the JAX CLI's
    ``ckpt_{step}.pkl`` payload; ``AutoencoderKLResi`` (or ``AutoencoderKL``)
    the tree that ``save_cfw_params`` writes under ``params``."""
    def sd(x):
        return x.state_dict() if isinstance(x, torch.nn.Module) else x

    if family in ("UNetModelDualcondV2", "EncoderUNetModelWT"):
        return _openai_unet_to_jax(sd(params))
    if family in ("AutoencoderKL", "AutoencoderKLResi"):
        return _ldm_vae_to_jax(sd(params))
    if family == "StableSRSSL":
        return {"unet": _openai_unet_to_jax(sd(params["unet"])),
                "structcond": _openai_unet_to_jax(sd(params["structcond"])),
                "null_context": _np_leaves(params["null_context"].detach().cpu().numpy())}
    raise KeyError(f"no carry to the JAX package for {family!r}; known: UNetModelDualcondV2, "
                   "EncoderUNetModelWT, StableSRSSL, AutoencoderKL, AutoencoderKLResi")


# reference-layout files: the prefix of a net in a full SD / StableSR
# checkpoint, and the top-level modules its converter in the JAX package reads
REFERENCE_LAYOUTS = {
    "vae": ("first_stage_model.", ("encoder", "decoder", "quant_conv", "post_quant_conv")),
    "unet": ("model.diffusion_model.",
             ("input_blocks", "output_blocks", "middle_block", "time_embed", "out", "fea_tran")),
    "structcond": ("structcond_stage_model.",
                   ("input_blocks", "output_blocks", "middle_block", "time_embed", "out",
                    "fea_tran")),
}


def has_reference_prefix(sd: dict, net: str) -> bool:
    return any(k.startswith(REFERENCE_LAYOUTS[net][0]) for k in sd)


@torch.no_grad()
def load_reference_state(module: torch.nn.Module, sd: dict, net: str) -> list[str]:
    """Load a reference-layout state dict into ``module`` (the port's ``net``:
    'vae', 'unet' or 'structcond') by its own keys, with the semantics of the
    JAX package's converters and ``merge_into_tree``:

    * a full checkpoint's keys under the net's prefix are taken (the prefix
      dropped); a file without that prefix is read as the bare net;
    * of those, the weights and biases under the net's top-level modules are
      the net's (the converters read those and nothing else: an ldm
      checkpoint's ``loss.*`` is not the VAE's);
    * a parameter the file lacks keeps its value (the fusion layers of a
      plain SD VAE keep their init), and a shape mismatch raises;
    * a key the module lacks is dropped, and returned.  The JAX merge adds
      such keys to the params tree, where no module reads them (the fusion
      layers of a CFW file loaded as a plain VAE).

    Values are cast to the parameters' type.  Raises when the file holds
    none of the module's parameters."""
    prefix, tops = REFERENCE_LAYOUTS[net]
    if has_reference_prefix(sd, net):
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    own = dict(module.named_parameters())
    loaded, dropped = 0, []
    for key, value in sd.items():
        if key.split(".", 1)[0] not in tops or key.rsplit(".", 1)[-1] not in ("weight", "bias"):
            continue
        if key not in own:
            dropped.append(key)
            continue
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"{net} parameter {key}: shape {tuple(value.shape)} in the file, "
                             f"{tuple(own[key].shape)} in the model")
        own[key].copy_(value)
        loaded += 1
    if not loaded:
        raise ValueError(f"no {net} parameters in the state dict (keys like {sorted(sd)[:4]})")
    return dropped
