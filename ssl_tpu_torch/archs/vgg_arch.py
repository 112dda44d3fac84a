"""VGG19 feature extractor for the perceptual loss (reference: archs/vgg_arch.py:55-161).

Counterpart of ``ssl_tpu/archs/vgg_arch.py::VGGFeatureExtractor``: named
taps ('conv1_1' ... 'conv5_4', relu/pool variants), ImageNet input
normalization and optional [-1, 1] -> [0, 1] range norm.  A 'convX_Y' tap is
taken before its ReLU.  The tower is built only as deep as the deepest tap.
``compute_dtype: bfloat16`` runs the tower in bf16 after the input
normalization, on bf16 copies of the float32 parameters, and returns every
tap as float32, as the JAX module does."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ssl_tpu_torch.archs.arch_util import Conv2d, compute_dtype_of, normal_init_
from ssl_tpu_torch.utils.registry import ARCH_REGISTRY

VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def vgg19_layer_names():
    names = []
    block, idx = 1, 1
    for v in VGG19_CFG:
        if v == "M":
            names.append(f"pool{block}")
            block += 1
            idx = 1
        else:
            names.append(f"conv{block}_{idx}")
            names.append(f"relu{block}_{idx}")
            idx += 1
    return names


def _conv_names():
    """Conv layer names in VGG19 order, with their torchvision ``features`` index."""
    out, block, idx, feat_i = [], 1, 1, 0
    for v in VGG19_CFG:
        if v == "M":
            block, idx, feat_i = block + 1, 1, feat_i + 1
        else:
            out.append((f"conv{block}_{idx}", feat_i))
            idx, feat_i = idx + 1, feat_i + 2
    return out


@ARCH_REGISTRY.register()
class VGGFeatureExtractor(nn.Module):
    """Runs VGG19 until the deepest requested layer; returns a dict of taps."""

    def __init__(self, layer_name_list=("conv5_4",), use_input_norm: bool = True,
                 range_norm: bool = False, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.layer_name_list = tuple(layer_name_list)
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        names = vgg19_layer_names()
        self._last = max(names.index(n) for n in self.layer_name_list)
        self.convs = nn.ModuleDict()
        cin, block, idx, pos = 3, 1, 1, 0
        for v in VGG19_CFG:
            if pos > self._last:
                break
            if v == "M":
                pos, block, idx = pos + 1, block + 1, 1
            else:
                self.convs[f"conv{block}_{idx}"] = Conv2d(cin, v, 3, 1, 1)
                cin, pos, idx = v, pos + 2, idx + 1
        self.register_buffer("mean", torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1),
                             persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_init_(self, generator)

    def forward(self, x):
        if self.range_norm:
            x = (x + 1.0) / 2.0
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        wanted = set(self.layer_name_list)
        out = {}
        block, idx, pos = 1, 1, 0
        for v in VGG19_CFG:
            if pos > self._last:
                break
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                if f"pool{block}" in wanted:
                    out[f"pool{block}"] = x
                pos, block, idx = pos + 1, block + 1, 1
                continue
            name = f"conv{block}_{idx}"
            x = self.convs[name](x)
            if name in wanted:
                out[name] = x
            pos += 1
            if pos > self._last:
                break
            x = F.relu(x)
            if f"relu{block}_{idx}" in wanted:
                out[f"relu{block}_{idx}"] = x
            pos, idx = pos + 1, idx + 1
        # bf16 taps come back in float32, as flax returns them; float64 stays
        return {k: v.to(torch.promote_types(v.dtype, torch.float32)) for k, v in out.items()}


def load_torchvision_vgg19(module: VGGFeatureExtractor, path: str) -> None:
    """Load a torchvision-format vgg19 state dict ('features.N.*') into ``module``."""
    sd = torch.load(path, map_location="cpu")
    with torch.no_grad():
        for name, feat_i in _conv_names():
            if name in module.convs:
                module.convs[name].weight.copy_(sd[f"features.{feat_i}.weight"])
                module.convs[name].bias.copy_(sd[f"features.{feat_i}.bias"])
