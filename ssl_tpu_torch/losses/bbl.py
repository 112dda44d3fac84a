"""BebyGAN's best-buddy loss and back-projection loss
(reference: models/bebyganssl_model.py:471-565, :724-728).

Counterpart of ``ssl_tpu/losses/bbl.py``.  The 3x3 stride-3 patches of SR
are each matched with the GT patch, among those of GT at scales 1, 1/2 and
1/4 (``F.interpolate`` bicubic, no antialias), that is nearest to both the
SR patch and the GT patch at its place; that "best buddy" is the L1 target.
The distances are ||x||^2 + ||y||^2 - 2 x.y, clamped at 0, as the JAX
module expands them; their product runs in fp32 with TF32 off whatever the
process sets, since a rounded distance may move an argmin."""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

from ssl_tpu_torch.ops.torch_resize import bebygan_imresize_down, interp_bicubic


@contextmanager
def _fp32_matmul():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _unfold_patches(x: torch.Tensor, ksize: int, stride: int) -> torch.Tensor:
    """NCHW -> (b, patches, c k k) on the valid grid (``F.unfold``, no pad)."""
    return F.unfold(x, ksize, stride=stride).transpose(1, 2)


def _pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xn = torch.sum(x ** 2, dim=2)[:, :, None]
    yn = torch.sum(y ** 2, dim=2)[:, None, :]
    return torch.clamp(xn + yn - 2.0 * torch.bmm(x, y.transpose(1, 2)), min=0.0)


def best_buddy_pairs(sr: torch.Tensor, gt: torch.Tensor, alpha=1.0, beta=1.0, ksize=3,
                     stride=3):
    """Returns (SR patches, their best-buddy GT patches, detached) for an L1
    criterion."""
    p1 = _unfold_patches(sr, ksize, stride)
    p2 = _unfold_patches(gt, ksize, stride)
    h, w = gt.shape[-2:]
    p2_cat = torch.cat([p2] + [_unfold_patches(interp_bicubic(gt, (h // s, w // s)), ksize,
                                               stride) for s in (2, 4)], dim=1)
    with torch.no_grad(), _fp32_matmul():
        score = alpha * _pairwise_sqdist(p1, p2_cat) + beta * _pairwise_sqdist(p2, p2_cat)
        ind = torch.argmin(score, dim=2)
        sel = torch.gather(p2_cat, 1, ind[..., None].expand(-1, -1, p2_cat.shape[-1]))
    return p1, sel


def back_projection_loss(sr: torch.Tensor, lq: torch.Tensor) -> torch.Tensor:
    """L1 between SR brought down to LQ's size (``bebygan_imresize_down``)
    and LQ."""
    return torch.mean(torch.abs(bebygan_imresize_down(sr, sr.shape[-2] // lq.shape[-2]) - lq))
