"""DISTS — Deep Image Structure and Texture Similarity (reference: metrics/dists.py).

Counterpart of ``ssl_tpu/metrics/dists_metric.py``: the dists-pytorch
package's VGG16 stages with L2 pooling, per-channel learned alpha / beta and
the structure + texture terms, NCHW.  The weights load from ``DISTS_PTH``
(the official ``weights.pt`` carries alpha / beta only) and ``VGG16_PTH``
(a torchvision VGG16 state dict for the convs).  Without a checkpoint the
metric raises; one that leaves a node unfilled is refused."""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from ssl_tpu_torch.metrics.metric_util import exact_float32, image_tensor
from ssl_tpu_torch.utils.device import resolve_device
from ssl_tpu_torch.utils.registry import METRIC_REGISTRY
from ssl_tpu_torch.utils.weight_port import load_torch_state_dict

_VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_CONVS = [(si, ci) for si, (_, n) in enumerate(_VGG16_STAGES) for ci in range(n)]


def l2_pool(x: torch.Tensor) -> torch.Tensor:
    """Hann-window L2 pooling (DISTS_pytorch ``L2pooling``: filter_size 5 ->
    the 3x3 kernel of hanning(5)[1:-1], stride 2, pad 1, depthwise):
    ``sqrt(conv(x^2, w) + 1e-12)``.  dists-pytorch puts it in place of every
    max pool between VGG stages."""
    a = x.new_tensor([0.5, 1.0, 0.5])
    w = a[:, None] * a[None, :]
    w = w / w.sum()
    c = x.shape[1]
    out = F.conv2d(x * x, w.expand(c, 1, 3, 3), stride=2, padding=1, groups=c)
    return torch.sqrt(out + 1e-12)


class VGG16Stages(nn.Module):
    """VGG16 features in 5 stages (conv ``s{stage}_c{i}``), L2 pooling
    between them; returns [input, stage 1, ..., stage 5]."""

    def __init__(self):
        super().__init__()
        cin = 3
        for si, ci in _CONVS:
            feats = _VGG16_STAGES[si][0]
            conv = nn.Conv2d(cin, feats, 3, padding=1)
            nn.init.zeros_(conv.bias)
            self.add_module(f"s{si}_c{ci}", conv)
            cin = feats

    def forward(self, x):
        outs = [x]
        for si, (_, n) in enumerate(_VGG16_STAGES):
            if si > 0:
                x = l2_pool(x)
            for ci in range(n):
                x = F.relu(getattr(self, f"s{si}_c{ci}")(x))
            outs.append(x)
        return outs


class DISTS(nn.Module):
    """Structure and texture similarity over the VGG16 stages: inputs NCHW
    in [0, 1], one distance per image (lower is better)."""

    def __init__(self):
        super().__init__()
        self.register_buffer("mean", torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1),
                             persistent=False)
        self.vgg16 = VGG16Stages()
        total_c = 3 + sum(c for c, _ in _VGG16_STAGES)
        self.alpha = nn.Parameter(torch.full((total_c,), 0.1))
        self.beta = nn.Parameter(torch.full((total_c,), 0.1))

    def forward(self, x, y):
        # stage 0 is the raw input (DISTS_pytorch forward_once returns
        # [x, relu1_2, ...], only the VGG path normalized)
        fx = [x] + self.vgg16((x - self.mean) / self.std)[1:]
        fy = [y] + self.vgg16((y - self.mean) / self.std)[1:]
        w_sum = self.alpha.sum() + self.beta.sum()
        c0 = c1 = 1e-6
        offset, score = 0, 0.0
        for a, b in zip(fx, fy):
            c = a.shape[1]
            al = self.alpha[offset:offset + c] / w_sum
            be = self.beta[offset:offset + c] / w_sum
            mu_a, mu_b = a.mean(dim=(2, 3)), b.mean(dim=(2, 3))
            var_a = a.var(dim=(2, 3), unbiased=False)
            var_b = b.var(dim=(2, 3), unbiased=False)
            cov = ((a - mu_a[..., None, None]) * (b - mu_b[..., None, None])).mean(dim=(2, 3))
            texture = (2 * mu_a * mu_b + c0) / (mu_a ** 2 + mu_b ** 2 + c0)
            structure = (2 * cov + c1) / (var_a + var_b + c1)
            score = score + (al * texture + be * structure).sum(dim=-1)
            offset += c
        return 1.0 - score


DISTS_REQUIRED_NODES = frozenset(["alpha", "beta"] + [f"vgg16.s{si}_c{ci}" for si, ci in _CONVS])


def load_dists_weights(state: dict, sd: dict, filled: set | None = None) -> dict:
    """Overlay a dists-pytorch checkpoint onto a ``DISTS`` state dict:
    alpha and beta (1, 1475, 1, 1) by name; the VGG16 convs, where the file
    carries them, in forward order (their shapes repeat within a stage, so
    they match by position).  Every node filled goes into ``filled``."""
    if filled is None:
        filled = set()
    state = dict(state)
    for name in ("alpha", "beta"):
        if name in sd:
            state[name] = sd[name].reshape(-1)
            filled.add(name)
    conv_keys = [k for k, v in sd.items()
                 if k.endswith(".weight") and v.dim() == 4 and tuple(v.shape[2:]) == (3, 3)]
    if conv_keys:
        if len(conv_keys) != len(_CONVS):
            raise ValueError(f"expected {len(_CONVS)} VGG16 convs, found {len(conv_keys)}")
        for (si, ci), k in zip(_CONVS, conv_keys):
            state[f"vgg16.s{si}_c{ci}.weight"] = sd[k]
            bk = k[: -len("weight")] + "bias"
            if bk in sd:
                state[f"vgg16.s{si}_c{ci}.bias"] = sd[bk]
            filled.add(f"vgg16.s{si}_c{ci}")
    return state


_CACHE: dict = {}


def dists_model(weights_path: str, device=None) -> DISTS:
    """The float32 ``DISTS`` of ``weights_path`` (with ``VGG16_PTH``'s convs
    where set) on ``device``, cached by (path, backbone, device)."""
    device = resolve_device(device)
    backbone = os.environ.get("VGG16_PTH")
    key = (weights_path, backbone, str(device))
    if key not in _CACHE:
        model = DISTS()
        state, filled = model.state_dict(), set()
        if backbone and os.path.exists(backbone):
            state = load_dists_weights(state, load_torch_state_dict(backbone, "params"), filled)
        state = load_dists_weights(state, load_torch_state_dict(weights_path, "params"), filled)
        missing = DISTS_REQUIRED_NODES - filled
        if missing:
            # the official weights.pt carries only alpha / beta: without
            # VGG16_PTH the backbone would score with random convs
            raise ValueError(
                f"DISTS weights incomplete: {len(missing)} node(s) unfilled "
                f"(e.g. {sorted(missing)[:3]}). The official DISTS weights.pt has "
                "only alpha/beta — also set VGG16_PTH to a torchvision vgg16 "
                "state dict for the backbone convs.")
        model.load_state_dict(state)
        _CACHE[key] = model.to(device).eval().requires_grad_(False)
    return _CACHE[key]


@METRIC_REGISTRY.register()
def calculate_dists(img, img2, crop_border=0, weights_path=None, device=None,
                    **kwargs) -> float:
    """img, img2: HWC [0,255] RGB. Lower is better. Requires DISTS_PTH."""
    path = weights_path or os.environ.get("DISTS_PTH")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "DISTS weights are not in the repository. Set DISTS_PTH to the "
            "dists-pytorch checkpoint (and VGG16_PTH to the backbone).")
    device = resolve_device(device)
    model = dists_model(path, device)
    a = image_tensor(img, crop_border, device)
    b = image_tensor(img2, crop_border, device)
    with torch.no_grad(), exact_float32():
        return float(model(a, b)[0])
