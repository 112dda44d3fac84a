"""VGG-feature self-similarity perceptual loss (``PerceptualSimLoss``).

Counterpart of ``ssl_tpu/losses/feature_sim.py`` (reference parity:
Diffusion-Based-SR/basicsr/losses/basic_loss.py:272-612): self-similarity
Grams over VGG19 feature maps, spatial (area-area) and channel-channel,
optionally within tiles or channel groups, whose mismatch between SR and GT
is penalized beside the perceptual and style terms.  NCHW throughout.

``ClipLoss`` (the same file in JAX) needs the CLIP ViT tower, which the port
does not have yet; it stays out of the registry until then (ROADMAP.md,
queue 1 item 11)."""

from __future__ import annotations

import os

import torch
from torch import nn

from ssl_tpu_torch.archs.vgg_arch import VGGFeatureExtractor, load_torchvision_vgg19
from ssl_tpu_torch.losses.simself_strategies import _area_tokens, _tiles, _unfold, _untile
from ssl_tpu_torch.utils.registry import LOSS_REGISTRY


def _l2_normalize(q):
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6)


def featsim_areaarea(img, is_shift=False, shift_h=4, shift_w=4, dh=32, dw=32,
                     kernel_size=5, softmax=True, rearrange_back=True,
                     crossentropy=False, temperature=0, cos_distance=False):
    """Spatial self-similarity of a feature map (reference
    basic_loss.py:489-548 ``simself_areaarea``).  ``dh == 0 or dw == 0``
    selects the GLOBAL path (every position against every position);
    otherwise positions compare within (dh, dw) tiles.  ``kernel_size > 0``
    gives each token its zero-padded k x k neighbourhood."""
    b, c, h, w = img.shape
    x = torch.roll(img, (-shift_h, -shift_w), (2, 3)) if is_shift else img
    if dh == 0 or dw == 0:
        q = (_unfold(x, kernel_size, padding=kernel_size // 2) if kernel_size > 0
             else x.reshape(b, c, h * w)).transpose(1, 2)             # b, hw, f
        if cos_distance:
            q = _l2_normalize(q)
        s = q @ q.transpose(1, 2)                                    # b, hw, hw
        if temperature != 0:
            s = s / temperature
        if softmax:
            s = torch.softmax(s, dim=-1)
        if crossentropy:
            return s.reshape(b * h * w, h * w)
        if rearrange_back:
            s = s.reshape(b, h * w, h, w)
            if is_shift:
                s = torch.roll(s, (shift_h, shift_w), (2, 3))
        return s
    if kernel_size > 0:
        q = _area_tokens(x, dh, dw, kernel_size)                     # b, H, W, T, c, k^2
        bb, H, W, t, cc, kk = q.shape
        q = q.reshape(bb, H, W, t, cc * kk)
    else:
        # the reference keeps the tile grid FLATTENED here ((b, hw, t, c),
        # basic_loss.py:532-534), so rearrange_back cannot apply below
        q = _tiles(x, dh, dw)
        bb, H, W, t, cc = q.shape
        q = q.reshape(bb, H * W, t, cc)
    if cos_distance:
        q = _l2_normalize(q)
    s = q @ q.transpose(-1, -2)
    if temperature != 0:
        s = s / temperature
    if softmax:
        s = torch.softmax(s, dim=-1)
    if crossentropy:
        return s.reshape(bb * H * W * t, t)
    if rearrange_back:
        if kernel_size <= 0:
            raise ValueError(
                "rearrange_back with kernel_size=0 tiles: the flattened (b, hw, t, t) map "
                "has no 5-D tile layout (the reference errors here too, basic_loss.py:545); "
                "use crossentropy or rearrange_back=False")
        s = _untile(s, dh, dw)
        if is_shift:
            s = torch.roll(s, (shift_h, shift_w), (2, 3))
    return s


def _reflect_last(q, pad: int):
    """Reflect-pad the last axis (edge not repeated)."""
    n = q.shape[-1]
    idx = torch.cat([torch.arange(pad, 0, -1), torch.arange(n),
                     torch.arange(n - 2, n - 2 - pad, -1)]).to(q.device)
    return q[..., idx]


def _unfold_lastdim(q, k: int):
    """torch ``.unfold(dimension=-1, step=1, size=k)``."""
    return q.unfold(-1, k, 1)


def featsim_channelchannel(img, is_shift=False, shift_c=4, dc=32, kernel_size=5,
                           softmax=True, crossentropy=False, temperature=0,
                           cos_distance=False):
    """Channel self-similarity of a feature map (reference
    basic_loss.py:550-596 ``simself_channelchannel``).  ``dc == 0`` compares
    every channel with every channel, else channels compare within size-dc
    groups; ``kernel_size > 0`` gives each channel's token its
    reflect-padded neighbouring channels."""
    b, c, h, w = img.shape
    x = torch.roll(img, -shift_c, 1) if is_shift else img
    if dc == 0:
        if kernel_size > 0:
            q = _reflect_last(x.permute(0, 2, 3, 1), kernel_size // 2)     # b, h, w, c + 2e
            q = _unfold_lastdim(q, kernel_size)                              # b, h, w, c, k
            q = q.permute(0, 3, 1, 2, 4).reshape(b, c, h * w * kernel_size)
        else:
            q = x.reshape(b, c, h * w)
        if cos_distance:
            q = _l2_normalize(q)
        s = q @ q.transpose(1, 2)                                            # b, c, c
        if temperature != 0:
            s = s / temperature
        if softmax:
            s = torch.softmax(s, dim=-1)
        if crossentropy:
            s = s.reshape(b * c, c)
        return s
    C = c // dc
    q = x.reshape(b, C, dc, h * w).transpose(2, 3)                           # b, C, hw, dc
    if kernel_size > 0:
        q = _unfold_lastdim(_reflect_last(q, kernel_size // 2), kernel_size)  # b, C, hw, dc, k
        q = q.permute(0, 1, 3, 2, 4).reshape(b, C, dc, h * w * kernel_size)
    else:
        q = q.transpose(2, 3)                                                # b, C, dc, hw
    if cos_distance:
        q = _l2_normalize(q)
    s = q @ q.transpose(-1, -2)                                              # b, C, dc, dc
    if temperature != 0:
        s = s / temperature
    if softmax:
        s = torch.softmax(s, dim=-1)
    if crossentropy:
        s = s.reshape(b * C * dc, dc)
    return s


def _soft_cross_entropy(logits, target):
    """CrossEntropyLoss with probability targets, the mean over rows."""
    return torch.mean(torch.sum(-target * torch.log_softmax(logits, dim=-1), dim=-1))


def _gram(x):
    n, c, h, w = x.shape
    f = x.reshape(n, c, h * w)
    return f @ f.transpose(1, 2) / (c * h * w)


@LOSS_REGISTRY.register()
class PerceptualSimLoss(nn.Module):
    """Perceptual + style + feature-self-similarity loss (reference
    basic_loss.py:272-481).  Returns ``(percep, style, simself,
    simself_channel)``, each None when its weight is 0.

    The simself terms compare ``featsim_areaarea`` / ``featsim_channelchannel``
    maps of each layer whose weight in ``simself_layer_weights`` (or
    ``simself_channel_layer_wights``) is positive, in ``layer_weights``'
    order, with that layer's dh / dw / dc / kernel from the lists.  The
    style term uses the perceptual criterion (the reference reads a
    nonexistent attribute there, as the JAX package notes).  GT's features
    carry no gradient.  The VGG19 tower is frozen: its weights come from a
    torchvision ``vgg19`` state dict (``vgg_path`` or ``VGG19_PTH``), else
    from a generator seeded with ``vgg_seed``."""

    def __init__(self, layer_weights, vgg_type="vgg19", use_input_norm=True,
                 range_norm=False, perceptual_weight=1.0, style_weight=0.0,
                 criterion_perceptual_style="l1",
                 simself_weight=0.0, simself_layer_weights=(0, 0, 1, 1, 1),
                 criterion_simself="l1",
                 feat_simself_dh_list=(0, 0, 16, 16, 0),
                 feat_simself_dw_list=(0, 0, 16, 16, 0),
                 feat_kernel_size_list=(0, 0, 0, 0, 0),
                 cos_distance=False, temperature=0, softmax_sr=True,
                 softmax_gt=True, rearrange_back=True, crossentropy=False,
                 simself_channel_weight=0.0,
                 simself_channel_layer_wights=(0, 0, 1, 1, 1),
                 criterion_simself_channel="l1",
                 feat_simself_dc_list=(0, 0, 16, 16, 16),
                 feat_channel_kernel_size_list=(0, 0, 0, 0, 0),
                 vgg_path=None, vgg_seed: int = 0):
        super().__init__()
        if not vgg_type.startswith("vgg19"):
            raise NotImplementedError("only vgg19 is wired up (reference default)")
        if criterion_perceptual_style not in ("l1", "l2", "fro"):
            raise NotImplementedError(
                f"{criterion_perceptual_style} criterion has not been supported.")
        for crit in (criterion_simself, criterion_simself_channel):
            if crit not in ("l1", "crossentropy"):
                raise NotImplementedError(f"{crit} criterion has not been supported.")
        self.layer_weights = dict(layer_weights)
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.criterion_perceptual_style = criterion_perceptual_style
        self.simself_weight = simself_weight
        self.simself_layer_weights = tuple(simself_layer_weights)
        self.criterion_simself = criterion_simself
        self.feat_simself_dh_list = tuple(feat_simself_dh_list)
        self.feat_simself_dw_list = tuple(feat_simself_dw_list)
        self.feat_kernel_size_list = tuple(feat_kernel_size_list)
        self.cos_distance = cos_distance
        self.temperature = temperature
        self.softmax_sr = softmax_sr
        self.softmax_gt = softmax_gt
        self.rearrange_back = rearrange_back
        self.crossentropy = crossentropy
        self.simself_channel_weight = simself_channel_weight
        self.simself_channel_layer_wights = tuple(simself_channel_layer_wights)
        self.criterion_simself_channel = criterion_simself_channel
        self.feat_simself_dc_list = tuple(feat_simself_dc_list)
        self.feat_channel_kernel_size_list = tuple(feat_channel_kernel_size_list)
        self.vgg = VGGFeatureExtractor(layer_name_list=tuple(self.layer_weights),
                                       use_input_norm=use_input_norm, range_norm=range_norm)
        vgg_path = vgg_path or os.environ.get("VGG19_PTH")
        if vgg_path and os.path.exists(vgg_path):
            load_torchvision_vgg19(self.vgg, vgg_path)
        else:
            self.vgg.reset_parameters(torch.Generator().manual_seed(vgg_seed))
        self.vgg.requires_grad_(False)
        self.vgg.eval()

    def train(self, mode: bool = True):
        # the tower stays in eval mode: it is a fixed feature map
        super().train(mode)
        self.vgg.eval()
        return self

    def _dist(self, a, b):
        if self.criterion_perceptual_style == "l1":
            return torch.mean(torch.abs(a - b))
        if self.criterion_perceptual_style == "l2":
            return torch.mean((a - b) ** 2)
        return torch.linalg.vector_norm(a - b)

    @staticmethod
    def _sim_dist(a, b, criterion):
        if criterion == "l1":
            return torch.mean(torch.abs(a - b))
        return _soft_cross_entropy(a, b)

    def _simself(self, fx, fgt, weight, layer_weights, criterion, featsim, layer_kw):
        total = 0.0
        for idx, k in enumerate(self.layer_weights):
            if layer_weights[idx] <= 0:
                continue
            kw = layer_kw(idx)
            sx = featsim(fx[k], softmax=self.softmax_sr, **kw)
            sg = featsim(fgt[k], softmax=self.softmax_gt, **kw)
            total = total + self._sim_dist(sx, sg, criterion) * layer_weights[idx]
        return total * weight

    def forward(self, x, gt):
        """x, gt: NCHW in [0, 1] (``range_norm`` maps [-1, 1]).  Returns
        (percep, style, simself, simself_channel)."""
        fx = self.vgg(x)
        with torch.no_grad():
            fgt = self.vgg(gt.detach())
        percep = style = simself = simself_channel = None
        if self.perceptual_weight > 0:
            percep = sum(self._dist(fx[k], fgt[k]) * w for k, w in self.layer_weights.items())
            percep = percep * self.perceptual_weight
        if self.style_weight > 0:
            style = sum(self._dist(_gram(fx[k]), _gram(fgt[k])) * w
                        for k, w in self.layer_weights.items())
            style = style * self.style_weight
        if self.simself_weight > 0:
            simself = self._simself(
                fx, fgt, self.simself_weight, self.simself_layer_weights,
                self.criterion_simself, featsim_areaarea,
                lambda i: dict(is_shift=False, shift_h=4, shift_w=4,
                               dh=self.feat_simself_dh_list[i], dw=self.feat_simself_dw_list[i],
                               kernel_size=self.feat_kernel_size_list[i],
                               rearrange_back=self.rearrange_back,
                               crossentropy=self.crossentropy, temperature=self.temperature,
                               cos_distance=self.cos_distance))
        if self.simself_channel_weight > 0:
            simself_channel = self._simself(
                fx, fgt, self.simself_channel_weight, self.simself_channel_layer_wights,
                self.criterion_simself_channel, featsim_channelchannel,
                lambda i: dict(is_shift=False, shift_c=4, dc=self.feat_simself_dc_list[i],
                               kernel_size=self.feat_channel_kernel_size_list[i],
                               crossentropy=self.crossentropy, temperature=self.temperature,
                               cos_distance=self.cos_distance))
        return percep, style, simself, simself_channel
