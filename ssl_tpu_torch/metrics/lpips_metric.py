"""LPIPS — Learned Perceptual Image Patch Similarity (reference: metrics/lpips.py).

Counterpart of ``ssl_tpu/metrics/lpips_metric.py``: the AlexNet flavour of
the ``lpips`` package, NCHW.  The backbone and the learned linear heads load
from torch checkpoints: ``LPIPS_ALEX_PTH`` (the lpips package's
``alex.pth``, which carries the heads only) and ``ALEXNET_PTH`` (a
torchvision AlexNet state dict for the convs).  Without a checkpoint the
metric raises; a checkpoint that leaves a conv or a head unfilled is
refused."""

from __future__ import annotations

import os
import re

import torch
import torch.nn.functional as F
from torch import nn

from ssl_tpu_torch.metrics.metric_util import exact_float32, image_tensor
from ssl_tpu_torch.utils.device import resolve_device
from ssl_tpu_torch.utils.registry import METRIC_REGISTRY
from ssl_tpu_torch.utils.weight_port import load_torch_state_dict

_CHANNELS = (64, 192, 384, 256, 256)


class AlexNetFeatures(nn.Module):
    """Torchvision AlexNet.features, returning the 5 relu taps LPIPS uses."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 11, stride=4, padding=2)
        self.conv2 = nn.Conv2d(64, 192, 5, padding=2)
        self.conv3 = nn.Conv2d(192, 384, 3, padding=1)
        self.conv4 = nn.Conv2d(384, 256, 3, padding=1)
        self.conv5 = nn.Conv2d(256, 256, 3, padding=1)
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4, self.conv5):
            nn.init.zeros_(conv.bias)     # flax's init: a checkpoint without biases keeps 0

    def forward(self, x):
        taps = []
        x = F.relu(self.conv1(x))
        taps.append(x)
        x = F.relu(self.conv2(F.max_pool2d(x, 3, 2)))
        taps.append(x)
        x = F.relu(self.conv3(F.max_pool2d(x, 3, 2)))
        taps.append(x)
        x = F.relu(self.conv4(x))
        taps.append(x)
        x = F.relu(self.conv5(x))
        taps.append(x)
        return taps


class LPIPSAlex(nn.Module):
    """Normalized feature distance with learned per-channel linear weights;
    inputs NCHW in [-1, 1] (the LPIPS convention), one distance per image."""

    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1),
                             persistent=False)
        self.net = AlexNetFeatures()
        for i, c in enumerate(_CHANNELS):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(c)))

    def forward(self, x, y):
        fx = self.net((x - self.shift) / self.scale)
        fy = self.net((y - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            # the lpips package's 1x1-conv head verbatim (no abs: the official
            # heads are trained non-negative)
            w = getattr(self, f"lin{i}").view(1, -1, 1, 1)
            total = total + ((a - b) ** 2 * w).sum(dim=1).mean(dim=(1, 2))
        return total


_ALEX_CONV_SHAPES = {(64, 3, 11, 11): "conv1", (192, 64, 5, 5): "conv2",
                     (384, 192, 3, 3): "conv3", (256, 384, 3, 3): "conv4",
                     (256, 256, 3, 3): "conv5"}

LPIPS_REQUIRED_NODES = frozenset(
    [f"net.conv{i}" for i in range(1, 6)] + [f"lin{i}" for i in range(5)])


def load_lpips_weights(state: dict, sd: dict, filled: set | None = None) -> dict:
    """Overlay an AlexNet / lpips torch state dict onto an ``LPIPSAlex``
    state dict.  The backbone convs match by SHAPE (torchvision's
    ``features.{idx}.weight`` and the lpips package's ``net.slice{n}.{idx}.weight``
    both carry AlexNet's unique conv shapes), the heads by NAME
    (``lin{i}.model.1.weight``, shape (1, C, 1, 1)).  Every node filled goes
    into ``filled``."""
    if filled is None:
        filled = set()
    state = dict(state)
    for k, v in sd.items():
        if k.endswith(".weight") and tuple(v.shape) in _ALEX_CONV_SHAPES:
            name = _ALEX_CONV_SHAPES[tuple(v.shape)]
            state[f"net.{name}.weight"] = v
            bk = k[: -len("weight")] + "bias"
            if bk in sd:
                state[f"net.{name}.bias"] = sd[bk]
            filled.add(f"net.{name}")
        m = re.search(r"lin(\d)\.model\.1\.weight$", k)
        if m:
            state[f"lin{m.group(1)}"] = v.reshape(-1)
            filled.add(f"lin{m.group(1)}")
    return state


_CACHE: dict = {}


def lpips_model(weights_path: str, device=None) -> LPIPSAlex:
    """The float32 ``LPIPSAlex`` of ``weights_path`` (with ``ALEXNET_PTH``'s
    backbone where set) on ``device``, cached by (path, backbone, device)."""
    device = resolve_device(device)
    backbone = os.environ.get("ALEXNET_PTH")
    key = (weights_path, backbone, str(device))
    if key not in _CACHE:
        model = LPIPSAlex()
        state, filled = model.state_dict(), set()
        if backbone and os.path.exists(backbone):
            state = load_lpips_weights(state, load_torch_state_dict(backbone, "params"), filled)
        state = load_lpips_weights(state, load_torch_state_dict(weights_path, "params"), filled)
        missing = LPIPS_REQUIRED_NODES - filled
        if missing:
            # the official alex.pth has only the heads: without ALEXNET_PTH the
            # backbone would score with random convs
            raise ValueError(
                f"LPIPS weights incomplete: {sorted(missing)} not found in the "
                "checkpoint(s). The official lpips alex.pth carries only the "
                "lin heads — also set ALEXNET_PTH to a torchvision alexnet "
                "state dict for the backbone convs.")
        model.load_state_dict(state)
        _CACHE[key] = model.to(device).eval().requires_grad_(False)
    return _CACHE[key]


@METRIC_REGISTRY.register()
def calculate_lpips(img, img2, crop_border=0, weights_path=None, device=None,
                    **kwargs) -> float:
    """img, img2: HWC [0,255] uint8/float RGB (the reference's convention).
    Lower is better.  Requires LPIPS weights (LPIPS_ALEX_PTH)."""
    path = weights_path or os.environ.get("LPIPS_ALEX_PTH")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "LPIPS weights are not in the repository. Set LPIPS_ALEX_PTH to a "
            "torch lpips-alex checkpoint (and ALEXNET_PTH to the backbone).")
    device = resolve_device(device)
    model = lpips_model(path, device)
    a = image_tensor(img, crop_border, device) * 2 - 1
    b = image_tensor(img2, crop_border, device) * 2 - 1
    with torch.no_grad(), exact_float32():
        return float(model(a, b)[0])
