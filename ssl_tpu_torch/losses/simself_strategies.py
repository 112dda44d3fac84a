"""The diffusion tree's ``simself_strategy`` zoo in PyTorch.

Counterpart of ``ssl_tpu/losses/simself_strategies.py`` (reference spec:
Diffusion-Based-SR/basicsr/losses/loss_util.py:183-1519, the class
``similarity_map`` and the module-level ``self_similarity``,
``gradient_img_similarity``, ``trainable_similarity_map`` and
``judge_abnormal_pixel``).  Every branch of the reference's dispatch
(loss_util.py:269-363) is here under the JAX package's names, and
``areaarea_mask_nonlocalavg_cuda_v1_p`` raises as there (its method is
commented out in the reference, loss_util.py:1401-1415).  Images are NCHW
throughout; JAX's ``simself_strategy_loss`` takes NHWC and transposes.

Three families:

* dense tile strategies (imgimg / gradimg / gradgrad / areaarea*): per-tile
  Gram or SSD matrices over a (dh, dw) tile grid, batched matmuls;
* masked strategies (areaarea_mask_nonlocal / _trans / _slow / _patch /
  mutual): per-edge-pixel ``ks x ks`` tiles of the reflect-padded image, with
  the neighbourhoods unfolded with ZERO padding inside the tile
  (loss_util.py:752-756).  For ``areaarea_mask_nonlocal`` that is the CUDA
  op's raw SSD (the centre window lies inside the tile, candidates beyond it
  read as zero), so it shares ``_rows_cuda_v1``.  ``_slow`` reflect-pads the
  tile instead and takes the centre neighbourhood from the reflect-padded
  full image (:809-824), values that differ from the CUDA op's and are
  mirrored exactly.  The per-pixel neighbourhoods of ``_slow``, ``_trans``
  and the mutual variant, (n, c kc^2, ks^2), are formed ``ROW_CHUNK_BYTES``
  at a time and recomputed in the backward;
* CUDA-op epilogues (``*_cuda_v*``): thin epilogues (loss_util.py:1180-1399)
  over the raw SSD of the reference's similarity.cu, served by the gather
  API (``ops/ssg.py::ssd_rows``).

Positions: ``capacity=None`` takes every edge pixel of the concrete mask
(the reference's shapes, empty ``_patch`` tiles skipped); an int gives each
image (each tile in the ``_patch`` variants) ``capacity`` rows in
``mask_to_positions``' layout, rows past the true count being those of pixel
(0, 0) and ``valid`` False.  Those padding rows are computed once per image
and repeated, so their cost does not grow with the capacity.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ssl_tpu_torch.losses.basic_loss import KLDistanceLoss
from ssl_tpu_torch.ops.ssg import apply_mask_stride, reflect_index, ssd_rows

# per-pixel neighbourhood tensors are formed at most this many bytes at a time
ROW_CHUNK_BYTES = 1 << 28


class SimMap(NamedTuple):
    """Result bundle mirroring the reference class attributes."""
    s: torch.Tensor
    s1: Optional[torch.Tensor] = None          # mutual / maxh variants
    index: Optional[torch.Tensor] = None       # gradfilter
    valid: Optional[torch.Tensor] = None       # per-row validity (capacity mode)

    def getitem(self):
        return self.s

    def getitem_simmutual(self):
        return self.s, self.s1

    def getitem_gradfilter(self):
        return self.s, self.index


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _reflect(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the trailing two dims as ``np.pad(mode='reflect')`` does,
    also where pad >= the size (then it reflects again)."""
    if pad == 0:
        return x
    h, w = x.shape[-2:]
    if pad < h and pad < w:
        return F.pad(x, (pad, pad, pad, pad), mode="reflect")
    iy, ix = reflect_index(h, pad, x.device), reflect_index(w, pad, x.device)
    return x[..., iy[:, None], ix[None, :]]


def _unfold(x: torch.Tensor, k: int, stride: int = 1, padding: int = 0,
            pad_mode: str = "zero") -> torch.Tensor:
    """``F.unfold`` with zero or reflect padding: (b, c, h, w) -> (b, c k k, L),
    block elements channel-major then (ky, kx) row-major, L row-major."""
    if padding and pad_mode != "zero":
        x, padding = _reflect(x, padding), 0
    return F.unfold(x, k, padding=padding, stride=stride)


def _tiles(x: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """(b, c, (H dh), (W dw)) -> (b, H, W, dh dw, c) patch tokens."""
    b, c, hh, ww = x.shape
    H, W = hh // dh, ww // dw
    x = x.reshape(b, c, H, dh, W, dw)
    return x.permute(0, 2, 4, 3, 5, 1).reshape(b, H, W, dh * dw, c)


def _untile(s: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """(b, H, W, dh dw, C) -> (b, C, (H dh), (W dw))."""
    b, H, W, _, C = s.shape
    s = s.reshape(b, H, W, dh, dw, C)
    return s.permute(0, 5, 1, 3, 2, 4).reshape(b, C, H * dh, W * dw)


def _tile_grid(x: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """(b, c, (H dh), (W dw)) -> (b, H W, c, dh, dw) (loss_util.py:1199-1201)."""
    b, c, hh, ww = x.shape
    H, W = hh // dh, ww // dw
    x = x.reshape(b, c, H, dh, W, dw)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(b, H * W, c, dh, dw)


def _roll(x, sh, sw, dims):
    return torch.roll(x, (sh, sw), dims)


def _softmax(s):
    return torch.softmax(s, dim=-1)


def _gram(q):
    return q @ q.transpose(-1, -2)


def get_gradient(x: torch.Tensor) -> torch.Tensor:
    """Central-difference gradient magnitude per channel, zero padding
    (loss_util.py:197-218)."""
    xp = F.pad(x, (1, 1, 1, 1))
    gv = xp[:, :, 2:, 1:-1] - xp[:, :, :-2, 1:-1]
    gh = xp[:, :, 1:-1, 2:] - xp[:, :, 1:-1, :-2]
    return torch.sqrt(gv * gv + gh * gh + 1e-6)


def _gray(img: torch.Tensor) -> torch.Tensor:
    return ((img[:, 0] + img[:, 1] + img[:, 2]) / 3)[:, None]


def _area_tokens(img, dh, dw, kernel_size, stride=1, pad_mode="zero", padding=None):
    """Per-tile unfolded neighbourhoods (b, H, W, T, c, k^2), T tokens a tile
    (loss_util.py:432-441): the tiles are laid out as a (b, c H W, dh, dw)
    image and unfolded, so neighbourhoods never cross tile borders."""
    b, c, hh, ww = img.shape
    H, W = hh // dh, ww // dw
    q = img.reshape(b, c, H, dh, W, dw).permute(0, 1, 2, 4, 3, 5)
    q = q.reshape(b, c * H * W, dh, dw)
    if padding is None:
        padding = kernel_size // 2
    q = _unfold(q, kernel_size, stride=stride, padding=padding, pad_mode=pad_mode)
    t = q.shape[-1]
    q = q.reshape(b, c, H * W, kernel_size * kernel_size, t).permute(0, 2, 4, 1, 3)
    return q.reshape(b, H, W, t, c, kernel_size * kernel_size)


def _flat_tokens(q):
    b, H, W, t, c, kk = q.shape
    return q.reshape(b, H, W, t, c * kk)


# ---------------------------------------------------------------------------
# dense tile strategies
# ---------------------------------------------------------------------------

def simself_imgimg(img, is_shift=False, shift_h=16, shift_w=16, dh=32, dw=32,
                   softmax=True) -> SimMap:
    x = _roll(img, -shift_h, -shift_w, (2, 3)) if is_shift else img
    q = _tiles(x, dh, dw)
    s = _gram(q)
    if softmax:
        s = _softmax(s)
    s = _untile(s, dh, dw)
    if is_shift:
        s = _roll(s, shift_h, shift_w, (1, 2))   # the reference rolls dims (1, 2)
    return SimMap(s=s)


def self_similarity(tensor, is_shift=False, shift_h=4, shift_w=4, dh=32, dw=32):
    """Module-level helper (loss_util.py:183-194): always softmax."""
    return simself_imgimg(tensor, is_shift, shift_h, shift_w, dh, dw, softmax=True).s


def simself_gradimg(img, is_shift=False, shift_h=4, shift_w=4, dh=32, dw=32,
                    gray=False, threshold=2e-3, softmax=True) -> SimMap:
    x = _gray(img) if gray else img
    grad = get_gradient(x)
    grad = torch.where(grad <= threshold, torch.zeros_like(grad), grad)
    if is_shift:
        grad = _roll(grad, -shift_h, -shift_w, (2, 3))
        x = _roll(x, -shift_h, -shift_w, (2, 3))
    s = _tiles(grad, dh, dw) @ _tiles(x, dh, dw).transpose(-1, -2)
    if softmax:
        s = _softmax(s)
    s = _untile(s, dh, dw)
    if is_shift:
        s = _roll(s, shift_h, shift_w, (1, 2))
    return SimMap(s=s)


def gradient_img_similarity(img, is_shift=False, shift_h=16, shift_w=16, dh=32, dw=32,
                            gray=False, threshold=1e-3):
    """Module-level helper (loss_util.py:221-240): always softmax."""
    return simself_gradimg(img, is_shift, shift_h, shift_w, dh, dw, gray, threshold,
                           softmax=True).s


def simself_gradgrad(img, is_shift=False, shift_h=4, shift_w=4, dh=32, dw=32,
                     gray=False, threshold=2e-3) -> SimMap:
    x = _gray(img) if gray else img
    grad = get_gradient(x)
    grad = torch.where(grad <= threshold, torch.zeros_like(grad), grad)
    if is_shift:
        grad = _roll(grad, -shift_h, -shift_w, (2, 3))
    s = _untile(_softmax(_gram(_tiles(grad, dh, dw))), dh, dw)
    if is_shift:
        s = _roll(s, shift_h, shift_w, (1, 2))
    return SimMap(s=s)


def _area_epilogue(s, dh, dw, softmax, rearrange_back, crossentropy, temperature,
                   is_shift, shift_h, shift_w, roll_dims=(1, 2)):
    b, H, W, t, _ = s.shape
    if temperature != 0:
        s = s / temperature
    if softmax:
        s = _softmax(s)
    if crossentropy:
        return s.reshape(b * H * W * t, t)
    if rearrange_back:
        s = _untile(s, dh, dw)
        if is_shift:
            s = _roll(s, shift_h, shift_w, roll_dims)
    return s


def simself_areaarea(img, is_shift=False, shift_h=4, shift_w=4, dh=32, dw=32,
                     kernel_size=5, softmax=True, rearrange_back=True,
                     crossentropy=False, temperature=1, mean=False) -> SimMap:
    x = _roll(img, -shift_h, -shift_w, (2, 3)) if is_shift else img
    q = _area_tokens(x, dh, dw, kernel_size)
    if mean:
        q = q - torch.mean(q, dim=-1, keepdim=True)
    s = _gram(_flat_tokens(q))
    s = _area_epilogue(s, dh, dw, softmax, rearrange_back, crossentropy, temperature,
                       is_shift, shift_h, shift_w)
    return SimMap(s=s)


def simself_areaarea_ori(img, is_shift=False, shift_h=4, shift_w=4, dh=32, dw=32,
                         kernel_size=5, mean=False) -> SimMap:
    x = _roll(img, -shift_h, -shift_w, (2, 3)) if is_shift else img
    q = _area_tokens(x, dh, dw, kernel_size)
    if mean:
        q = q - torch.mean(q, dim=-1, keepdim=True)
    s = _untile(_softmax(_gram(_flat_tokens(q))), dh, dw)
    if is_shift:
        s = _roll(s, shift_h, shift_w, (2, 3))   # _ori rolls (2, 3), not (1, 2)
    return SimMap(s=s)


def _pairwise_ssd(q):
    """(.., T, F) -> (.., T, T) squared L2 distances via the Gram identity."""
    sq = torch.sum(q * q, dim=-1)
    d = sq[..., :, None] + sq[..., None, :] - 2.0 * _gram(q)
    return torch.clamp(d, min=0.0)


def _nonlocal_map(img, is_shift, shift_h, shift_w, dh, dw, kernel_size, scaling_factor):
    x = _roll(img, -shift_h, -shift_w, (2, 3)) if is_shift else img
    q = _area_tokens(x, dh, dw, kernel_size)
    c = q.shape[4]
    d = _pairwise_ssd(_flat_tokens(q)) / (c * float(kernel_size) ** 2)
    return torch.exp(-d / scaling_factor)


def simself_areaarea_nonlocal(img, is_shift=False, shift_h=4, shift_w=4, dh=32, dw=32,
                              kernel_size=3, scaling_factor=1) -> SimMap:
    s = _nonlocal_map(img, is_shift, shift_h, shift_w, dh, dw, kernel_size, scaling_factor)
    s = _untile(s / (torch.sum(s, dim=-1, keepdim=True) + 1e-6), dh, dw)
    if is_shift:
        s = _roll(s, shift_h, shift_w, (1, 2))
    return SimMap(s=s)


def simself_areaarea_nonlocal_slow(img, is_shift=False, shift_h=4, shift_w=4, dh=32, dw=32,
                                   kernel_size=3, scaling_factor=1) -> SimMap:
    """_nonlocal's map normalized by the GLOBAL max (loss_util.py:536-537)."""
    s = _nonlocal_map(img, is_shift, shift_h, shift_w, dh, dw, kernel_size, scaling_factor)
    s = _untile(s / torch.max(s), dh, dw)
    if is_shift:
        s = _roll(s, shift_h, shift_w, (1, 2))
    return SimMap(s=s)


def simself_areaarea_cos(img, is_shift=False, shift_h=4, shift_w=4, dh=32, dw=32,
                         kernel_size=5, softmax=True, rearrange_back=True,
                         crossentropy=False, temperature=1) -> SimMap:
    x = _roll(img, -shift_h, -shift_w, (2, 3)) if is_shift else img
    q = _flat_tokens(_area_tokens(x, dh, dw, kernel_size))
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6)
    s = _area_epilogue(_gram(q), dh, dw, softmax, rearrange_back, crossentropy, temperature,
                       is_shift, shift_h, shift_w)
    return SimMap(s=s)


def simself_areaarea_stride(img, is_shift=False, shift_h=4, shift_w=4, dh=32, dw=32,
                            kernel_size=5, softmax=True, rearrange_back=True,
                            crossentropy=False, temperature=1, stride=1) -> SimMap:
    x = _roll(img, -shift_h, -shift_w, (2, 3)) if is_shift else img
    pad = math.ceil((kernel_size - stride) / 2)
    q = _flat_tokens(_area_tokens(x, dh, dw, kernel_size, stride=stride, padding=pad))
    s = _area_epilogue(_gram(q), dh // stride, dw // stride, softmax, rearrange_back,
                       crossentropy, temperature, is_shift, shift_h, shift_w)
    return SimMap(s=s)


def simself_areaarea_pad_roll(img, is_shift=False, shift_h=4, shift_w=4, dh=32, dw=32,
                              kernel_size=5, softmax=True, rearrange_back=True,
                              crossentropy=False, temperature=1) -> SimMap:
    """Cross-similarity between the unshifted and the rolled tilings, per-tile
    REFLECT padding (loss_util.py:615-664).  ``is_shift`` is unused: the roll
    of the second operand is unconditional, as in the reference."""
    q = _flat_tokens(_area_tokens(img, dh, dw, kernel_size, pad_mode="reflect"))
    x1 = _roll(img, -shift_h, -shift_w, (2, 3))
    q1 = _flat_tokens(_area_tokens(x1, dh, dw, kernel_size, pad_mode="reflect"))
    s = _area_epilogue(q @ q1.transpose(-1, -2), dh, dw, softmax, rearrange_back,
                       crossentropy, temperature, is_shift=False, shift_h=0, shift_w=0)
    return SimMap(s=s)


def simself_gradfilter(img, is_shift=False, shift_h=4, shift_w=4, dh=32, dw=32,
                       kernel_size=5, softmax=True, rearrange_back=True,
                       crossentropy=False, temperature=1, pix_num=0.75,
                       gray=False, index=None) -> SimMap:
    """Keep the top ``pix_num`` share of each tile's tokens by gradient-patch
    norm (descending), then a mean-centred Gram (loss_util.py:664-724).
    ``index`` reuses an earlier selection."""
    if is_shift:
        img = _roll(img, -shift_h, -shift_w, (2, 3))
    if index is None:
        if gray:
            img = _gray(img)
        qg = _flat_tokens(_area_tokens(get_gradient(img), dh, dw, kernel_size,
                                       pad_mode="reflect"))
        norms = torch.linalg.vector_norm(qg, dim=-1)
        order = torch.argsort(-norms, dim=-1, stable=True)
        index = order[..., :int(qg.shape[3] * pix_num)]
    q = _flat_tokens(_area_tokens(img, dh, dw, kernel_size, pad_mode="reflect"))
    b, H, W = q.shape[:3]
    # the reference's torch.gather with an index of shape (..., keep, 1)
    # selects feature column 0 only (loss_util.py:713): after the centring q
    # is all zeros and s a uniform softmax.  Mirrored exactly.
    q = torch.gather(q[..., :1], -2, index[..., None])
    q = q - torch.mean(q, dim=-1, keepdim=True)
    s = _gram(q)
    k = s.shape[-1]
    if temperature != 0:
        s = s / temperature
    if softmax:
        s = _softmax(s)
    if crossentropy:
        s = s.reshape(b * H * W * k, k)
    return SimMap(s=s, index=index)


# ---------------------------------------------------------------------------
# masked strategies: rows at edge pixels
# ---------------------------------------------------------------------------
# A row function takes (imgs (m, c, h, w), idx (n,) image of each row, pos
# (n, 2) (y, x)) and returns the (n, cols) rows, each from its own position
# only.

def _crop(imgs, idx, pos, size: int, pad: int):
    """(n, c, size, size) crops at ``pos`` of the images reflect-padded by
    ``pad``, the crop of pixel (y, x) starting at padded (y, x)."""
    P = _reflect(imgs, pad)
    r = torch.arange(size, device=imgs.device)
    ys = pos[:, 0, None].long() + r
    xs = pos[:, 1, None].long() + r
    return P[idx[:, None, None], :, ys[:, :, None], xs[:, None, :]].permute(0, 3, 1, 2)


def _gather_tiles(imgs, idx, pos, ks: int):
    """Each centre's ``ks x ks`` search tile from the reflect-padded image."""
    return _crop(imgs, idx, pos, ks, ks // 2)


def _by_chunks(fn, per_row: int, *rows):
    """``fn`` over row chunks of the tensors ``rows`` (equal first dims) that
    keep each chunk's ``per_row`` elements a row within ROW_CHUNK_BYTES, the
    results concatenated; under autograd each chunk is recomputed in the
    backward, so only its inputs and result are kept."""
    n = rows[0].shape[0]
    size = max(1, ROW_CHUNK_BYTES // max(1, per_row * rows[0].element_size()))
    grad = torch.is_grad_enabled() and any(r.requires_grad for r in rows)
    out = []
    for i in range(0, n, size):
        args = tuple(r[i:i + size] for r in rows)
        out.append(checkpoint(fn, *args, use_reentrant=False) if grad else fn(*args))
    return torch.cat(out) if len(out) != 1 else out[0]


def _tile_neighborhoods(tiles, kc: int):
    """(n, c, ks, ks) -> (n, c kc^2, ks^2) neighbourhoods inside each tile,
    zero padding beyond the tile edge (loss_util.py:752-756)."""
    return _unfold(tiles, kc, padding=kc // 2)


def _exp_rows(q, sigma, softmax, eps=1e-6):
    q = torch.exp(-q / sigma)
    if softmax:
        q = q / (torch.sum(q, dim=-1, keepdim=True) + eps)
    return q


def _rows_mask_nonlocal_slow(imgs, idx, pos, ks, kc, sigma, softmax):
    """Reflect-padded tiles, the centre neighbourhood from the reflect-padded
    full image (loss_util.py:809-824), all ks^2 neighbours at once."""
    e = kc // 2
    padded = _reflect(_gather_tiles(imgs, idx, pos, ks), e)
    centres = _crop(imgs, idx, pos, kc, e).reshape(len(idx), -1, 1)

    def ssd(p, ctr):
        return torch.sum((ctr - F.unfold(p, kc)) ** 2, dim=1)
    q = _by_chunks(ssd, imgs.shape[1] * kc * kc * ks * ks, padded, centres)
    return _exp_rows(q, sigma, softmax)


def _rows_mask_trans(imgs, idx, pos, ks, kc, mean, softmax, var):
    tiles = _gather_tiles(imgs, idx, pos, ks)
    c = tiles.shape[1]

    def rows(t):
        n = t.shape[0]
        nb = _tile_neighborhoods(t, kc).reshape(n, c, kc * kc, ks * ks)
        if mean:
            nb = nb - torch.mean(nb, dim=-2, keepdim=True)
        if var:
            nb = nb / (torch.var(nb, dim=-2, keepdim=True, correction=1) + 1e-8)
        nb = nb.reshape(n, c * kc * kc, ks * ks)
        return torch.einsum("nij,ni->nj", nb, nb[:, :, (ks * ks) // 2])
    q = _by_chunks(rows, c * kc * kc * ks * ks, tiles)
    return _softmax(q) if softmax else q


def _drop_center_col(q, ks):
    mid = ks * ks // 2
    return torch.cat([q[..., :mid], q[..., mid + 1:]], dim=-1)


# --- CUDA-op epilogues -----------------------------------------------------

def _raw_ssd(imgs, idx, pos, ks, kc):
    """The CUDA op's raw SSD rows (n, ks^2) through ``ops/ssg.py::ssd_rows``,
    each image's rows padded to the largest count there."""
    m = imgs.shape[0]
    if m == 1:
        return ssd_rows(imgs, pos[None], ks, kc)[0]
    counts = torch.bincount(idx, minlength=m)
    order = torch.argsort(idx, stable=True)
    slot = torch.empty_like(idx)
    slot[order] = (torch.arange(len(idx), device=idx.device)
                   - (torch.cumsum(counts, 0) - counts)[idx[order]])
    padded = pos.new_zeros((m, max(int(counts.max()), 1), 2))
    padded[idx, slot] = pos
    return ssd_rows(imgs, padded, ks, kc)[idx, slot]


def _rows_cuda_v1(imgs, idx, pos, ks, kc, sigma, softmax, avg=False, eps=1e-6):
    q = _raw_ssd(imgs, idx, pos, ks, kc)
    if avg:
        q = q / (imgs.shape[1] * float(kc) ** 2)
    return _exp_rows(q, sigma, softmax, eps)


def _rows_cuda_v2(imgs, idx, pos, ks, kc, sigma, softmax):
    return _exp_rows(torch.sqrt(_raw_ssd(imgs, idx, pos, ks, kc) + 1e-8), sigma, softmax)


def _rows_cuda_avg_v2(imgs, idx, pos, ks, kc, sigma, softmax):
    q = torch.exp(-(_raw_ssd(imgs, idx, pos, ks, kc) / (3 * float(kc) ** 2)) / sigma)
    q = _drop_center_col(q, ks)
    if softmax:
        q = q / (torch.sum(q, dim=-1, keepdim=True) + 1e-6)
    return q


def _rows_cuda_euler(imgs, idx, pos, ks, kc, sigma, softmax):
    q = _raw_ssd(imgs, idx, pos, ks, kc) / (3 * float(kc) ** 2) / sigma
    q = _drop_center_col(q, ks)
    return _softmax(-q) if softmax else q


def _rows_cuda_avg_v3(imgs, idx, pos, ks, kc, sigma, softmax):
    q = torch.exp(-(_raw_ssd(imgs, idx, pos, ks, kc) / (3 * float(kc) ** 2)) / sigma)
    q = q * (torch.sum(q, dim=-1, keepdim=True) / float(ks) ** 2)
    if softmax:
        q = q / (torch.sum(q, dim=-1, keepdim=True) + 1e-6)
    return q


def _rows_cuda_avg_v4(imgs, idx, pos, ks, kc_list, sigma, softmax):
    outs = [_exp_rows(_raw_ssd(imgs, idx, pos, ks, k) / (3 * float(k) ** 2), sigma, softmax,
                      eps=1e-10) for k in kc_list]
    return torch.amax(torch.stack(outs, dim=-1), dim=-1)


def _rows_cuda_v1rgb_channel(imgs, idx, pos, ks, kc, sigma, softmax):
    """One channel's rows of ``..._cuda_v1RGB`` (loss_util.py:1333-1350):
    imgs (m, 1, h, w)."""
    return _exp_rows(_raw_ssd(imgs, idx, pos, ks, kc) / float(kc) ** 2, sigma, softmax,
                     eps=1e-10)


def _rows_cuda_v5(imgs, idx, pos, ks, kc, sigma, softmax, gene_type, largest_k):
    q = torch.exp(-(_raw_ssd(imgs, idx, pos, ks, kc) / (imgs.shape[1] * float(kc) ** 2))
                  / sigma)
    if softmax:
        if gene_type == "sum":
            q = q / (torch.sum(q, dim=-1, keepdim=True) + 1e-10)
        elif gene_type == "softmax":
            q = _softmax(q)
    if largest_k > 0:
        q = torch.sort(q, dim=-1, descending=True).values[..., :largest_k]
    return q


def _rows_cuda_maxh(imgs_gt, imgs_sr, idx, pos, ks, kc, sigma, softmax):
    c = imgs_gt.shape[1]
    qg = _raw_ssd(imgs_gt, idx, pos, ks, kc) / (c * float(kc) ** 2)
    qs = _raw_ssd(imgs_sr, idx, pos, ks, kc) / (c * float(kc) ** 2)
    max_h = (qg - qs + 1e-20) / (torch.log((qg ** 2 + 1e-20) / (qs ** 2 + 1e-20)) + 1e-20)
    qg = torch.exp(-qg / max_h)
    qs = torch.exp(-qs / max_h)
    if softmax:
        qg = qg / (torch.sum(qg, dim=-1, keepdim=True) + 1e-20)
        qs = qs / (torch.sum(qs, dim=-1, keepdim=True) + 1e-20)
    return qg, qs


def trainable_sigma_rows(img, img_sr, pos, ks=25, kc=9, sigma=4.0, softmax=False):
    """``trainable_similarity_map.forward`` (loss_util.py:1446-1478): img and
    img_sr (c, h, w), pos (n, 2), and sigma a tensor (make it an
    ``nn.Parameter`` to train it).  Returns (s, s1)."""
    c = img.shape[0]
    sigma = torch.as_tensor(sigma, dtype=img.dtype, device=img.device)
    out = []
    for im in (img, img_sr):
        q = ssd_rows(im[None], pos[None], ks, kc)[0] / (c * float(kc) ** 2)
        q = torch.exp(-q / torch.relu(sigma) + 1e-20)
        if softmax:
            q = q / (torch.sum(q, dim=-1, keepdim=True) + 1e-20)
        out.append(q)
    return out[0], out[1]


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_DENSE = {
    "imgimg": lambda img, kw: simself_imgimg(
        img, kw["is_shift"], kw["shift_h"], kw["shift_w"], kw["dh"], kw["dw"], softmax=True),
    "gradimg": lambda img, kw: simself_gradimg(
        img, kw["is_shift"], kw["shift_h"], kw["shift_w"], kw["dh"], kw["dw"],
        kw["gray"], kw["threshold"]),
    "gradgrad": lambda img, kw: simself_gradgrad(
        img, kw["is_shift"], kw["shift_h"], kw["shift_w"], kw["dh"], kw["dw"],
        kw["gray"], kw["threshold"]),
    "areaarea": lambda img, kw: simself_areaarea(
        img, kw["is_shift"], kw["shift_h"], kw["shift_w"], kw["dh"], kw["dw"],
        kw["kernel_size"], kw["softmax"], kw["rearrange_back"], kw["crossentropy"],
        kw["temperature"], kw["mean"]),
    "areaarea_ori": lambda img, kw: simself_areaarea_ori(
        img, kw["is_shift"], kw["shift_h"], kw["shift_w"], kw["dh"], kw["dw"],
        kw["kernel_size"], kw["mean"]),
    "areaarea_nonlocal": lambda img, kw: simself_areaarea_nonlocal(
        img, kw["is_shift"], kw["shift_h"], kw["shift_w"], kw["dh"], kw["dw"],
        kw["kernel_size"], kw["scaling_factor"]),
    "areaarea_nonlocal_slow": lambda img, kw: simself_areaarea_nonlocal_slow(
        img, kw["is_shift"], kw["shift_h"], kw["shift_w"], kw["dh"], kw["dw"],
        kw["kernel_size"], kw["scaling_factor"]),
    "areaarea_cos": lambda img, kw: simself_areaarea_cos(
        img, kw["is_shift"], kw["shift_h"], kw["shift_w"], kw["dh"], kw["dw"],
        kw["kernel_size"], kw["softmax"], kw["rearrange_back"], kw["crossentropy"],
        kw["temperature"]),
    "areaarea_stride": lambda img, kw: simself_areaarea_stride(
        img, kw["is_shift"], kw["shift_h"], kw["shift_w"], kw["dh"], kw["dw"],
        kw["kernel_size"], kw["softmax"], kw["rearrange_back"], kw["crossentropy"],
        kw["temperature"], kw["stride"]),
    "areaarea_pad_roll": lambda img, kw: simself_areaarea_pad_roll(
        img, kw["is_shift"], kw["shift_h"], kw["shift_w"], kw["dh"], kw["dw"],
        kw["kernel_size"], kw["softmax"], kw["rearrange_back"], kw["crossentropy"],
        kw["temperature"]),
    # the reference dispatch hardcodes is_shift=False, shift 4, 4 here (:303)
    "areaarea_gradfilter": lambda img, kw: simself_gradfilter(
        img, False, 4, 4, kw["dh"], kw["dw"], kw["kernel_size"], kw["softmax"],
        kw["rearrange_back"], kw["crossentropy"], kw["temperature"], kw["pix_num"],
        kw["gray"], kw["index"]),
}

# masked families: row function (imgs, idx, pos, kw) -> (n, cols)
_MASKED = {
    # the tile's zero-padded neighbourhoods are the CUDA op's raw SSD, the
    # same sigma, eps and softmax: the same rows as ..._cuda_v1
    "areaarea_mask_nonlocal": lambda im, i, p, kw: _rows_cuda_v1(
        im, i, p, kw["kernel_size"], kw["kernel_size_center"], kw["scaling_factor"],
        kw["softmax"]),
    "areaarea_mask_nonlocal_slow": lambda im, i, p, kw: _rows_mask_nonlocal_slow(
        im, i, p, kw["kernel_size"], kw["kernel_size_center"], kw["scaling_factor"],
        kw["softmax"]),
    "areaarea_mask_trans": lambda im, i, p, kw: _rows_mask_trans(
        im, i, p, kw["kernel_size"], kw["kernel_size_center"], kw["mean"], kw["softmax"],
        kw["var"]),
    "areaarea_mask_nonlocal_cuda_v1": lambda im, i, p, kw: _rows_cuda_v1(
        im, i, p, kw["kernel_size"], kw["kernel_size_center"], kw["scaling_factor"],
        kw["softmax"]),
    "areaarea_mask_nonlocal_cuda_v2": lambda im, i, p, kw: _rows_cuda_v2(
        im, i, p, kw["kernel_size"], kw["kernel_size_center"], kw["scaling_factor"],
        kw["softmax"]),
    "areaarea_mask_nonlocalavg_cuda_v1": lambda im, i, p, kw: _rows_cuda_v1(
        im, i, p, kw["kernel_size"], kw["kernel_size_center"], kw["scaling_factor"],
        kw["softmax"], avg=True, eps=1e-20),
    "areaarea_mask_nonlocalavg_cuda_v2": lambda im, i, p, kw: _rows_cuda_avg_v2(
        im, i, p, kw["kernel_size"], kw["kernel_size_center"], kw["scaling_factor"],
        kw["softmax"]),
    "areaarea_mask_eulardistanceavg_cuda_v1": lambda im, i, p, kw: _rows_cuda_euler(
        im, i, p, kw["kernel_size"], kw["kernel_size_center"], kw["scaling_factor"],
        kw["softmax"]),
    "areaarea_mask_nonlocalavg_cuda_v3": lambda im, i, p, kw: _rows_cuda_avg_v3(
        im, i, p, kw["kernel_size"], kw["kernel_size_center"], kw["scaling_factor"],
        kw["softmax"]),
    "areaarea_mask_nonlocalavg_cuda_v4": lambda im, i, p, kw: _rows_cuda_avg_v4(
        im, i, p, kw["kernel_size"],
        kw["kernel_size_center"] if isinstance(kw["kernel_size_center"], (list, tuple))
        else [5, 9, 13], kw["scaling_factor"], kw["softmax"]),
    "areaarea_mask_nonlocalavg_cuda_v5": lambda im, i, p, kw: _rows_cuda_v5(
        im, i, p, kw["kernel_size"], kw["kernel_size_center"], kw["scaling_factor"],
        kw["softmax"], kw["gene_type"], kw["largest_k"]),
}

# per-(dh, dw)-tile masked families: the row function inside each grid tile
_PATCHED = {
    "areaarea_mask_nonlocal_patch": "areaarea_mask_nonlocal",
    "areaarea_mask_trans_patch": "areaarea_mask_trans",
    "areaarea_mask_nonlocal_cuda_v1_patch": "areaarea_mask_nonlocal_cuda_v1",
}

_DEFAULTS = dict(is_shift=False, shift_h=16, shift_w=16, dh=32, dw=32,
                 gray=False, threshold=2e-3, kernel_size=5, scaling_factor=4,
                 softmax=True, rearrange_back=True, crossentropy=False,
                 temperature=0, stride=1, pix_num=1, index=None,
                 kernel_size_center=9, mean=False, var=False, largest_k=0,
                 gene_type="sum")

_DEAD = "areaarea_mask_nonlocalavg_cuda_v1_p"


def _one_image(img, img_sr=None, needs_sr=False):
    if img.shape[0] != 1:
        raise ValueError(f"masked strategies are per image (b == 1), got b = {img.shape[0]}")
    if needs_sr and img_sr is None:
        raise ValueError("this strategy compares GT with SR: pass img_sr")


def similarity_map(img, mask=None, img_sr=None, simself_strategy="imgimg",
                   capacity=None, **kwargs) -> SimMap:
    """The reference's dispatch (loss_util.py:245-363).  img: (b, c, h, w);
    the masked strategies take b == 1 and mask (1, c1, h, w).  ``capacity``:
    None = every edge pixel of the concrete mask; an int = that many rows per
    image (per tile in the ``_patch`` variants) with ``valid``."""
    kw = dict(_DEFAULTS)
    kw.update(kwargs)
    strat = simself_strategy

    if strat in _DENSE:
        return _DENSE[strat](img, kw)

    if strat == _DEAD:
        raise NotImplementedError(
            "dead in the reference: simself_mask_nonlocalavg_cuda_v1_p is commented out "
            "(loss_util.py:1401), selecting it raises AttributeError there too")

    if strat == "areaarea_mask_nonlocalavg_cuda_v1RGB":
        _one_image(img)
        c = img.shape[1]
        mc = mask[0] if mask.shape[1] == c else mask[0].expand(c, -1, -1)
        rows, valids = zip(*(_rows_at(
            lambda im, i, p: _rows_cuda_v1rgb_channel(
                im, i, p, kw["kernel_size"], kw["kernel_size_center"], kw["scaling_factor"],
                kw["softmax"]),
            img[:, ch:ch + 1], mc[ch:ch + 1], capacity) for ch in range(c)))
        return SimMap(s=torch.cat(rows)[None], valid=torch.cat(valids))

    if strat == "areaarea_mask_nonlocalavg_cuda_maxh_v1":
        _one_image(img, img_sr, needs_sr=True)
        (qg, qs), valid = _rows_at(
            lambda im, i, p: _rows_cuda_maxh(
                im[:, 0], im[:, 1], i, p, kw["kernel_size"], kw["kernel_size_center"],
                kw["scaling_factor"], kw["softmax"]),
            torch.stack([img, img_sr], dim=1), mask[:, 0], capacity)
        return SimMap(s=qg[None], s1=qs[None], valid=valid)

    if strat == "areaarea_mask_nonlocal_patch_mutual":
        _one_image(img, img_sr, needs_sr=True)
        return _mutual_patch(img, img_sr, mask, kw, capacity)

    if strat in _PATCHED:
        _one_image(img)
        return _patched(strat, img, mask, kw, capacity)

    if strat in _MASKED:
        _one_image(img)
        s, valid = _rows_at(lambda im, i, p: _MASKED[strat](im, i, p, kw), img,
                            mask[:, 0], capacity)
        return SimMap(s=s[None], valid=valid)

    raise ValueError(f"unknown simself_strategy: {strat!r}")


def _rows_at(row_fn, imgs, masks2d, capacity):
    """``row_fn(imgs, idx, pos)`` at the edge pixels of each image (masks2d
    (m, h, w)), image-major, each image's in row-major order: every edge
    pixel with ``capacity=None`` (an empty image adds none, the reference's
    skip), else ``capacity`` rows per image as ``mask_to_positions`` lays
    them out, the padding rows those of pixel (0, 0), computed once per image.
    Returns (rows, valid); a tuple of rows if ``row_fn`` returns one.  JAX's
    ``_positions`` and its loops over images and tiles in one batch."""
    m = masks2d.shape[0]
    nz = torch.nonzero(masks2d == 1)
    idx, pos = nz[:, 0], nz[:, 1:]
    if capacity is None:
        return row_fn(imgs, idx, pos), torch.ones(len(idx), dtype=torch.bool,
                                                  device=idx.device)
    counts = torch.bincount(idx, minlength=m)
    start = torch.cumsum(counts, 0) - counts
    keep = torch.arange(len(idx), device=idx.device) - start[idx] < capacity
    idx, pos = idx[keep], pos[keep]
    n = torch.clamp(counts, max=capacity)
    first = torch.cumsum(n, 0) - n
    # the kept rows, then one row of pixel (0, 0) per image
    image = torch.arange(m, device=idx.device)
    rows = row_fn(imgs, torch.cat([idx, image]), torch.cat([pos, pos.new_zeros((m, 2))]))
    slot = torch.arange(capacity, device=idx.device)
    src = torch.where(slot[None] < n[:, None], first[:, None] + slot[None],
                      len(idx) + image[:, None]).reshape(-1)
    valid = (slot[None] < n[:, None]).reshape(-1)
    if isinstance(rows, tuple):
        return tuple(r[src] for r in rows), valid
    return rows[src], valid


def _rows_mask_trans_nosoftmax(im, i, p, kw):
    return _rows_mask_trans(im, i, p, kw["kernel_size"], kw["kernel_size_center"],
                            kw["mean"], softmax=False, var=kw["var"])


def _patched(strat, img, mask, kw, capacity):
    """Masked rows inside each (dh, dw) grid tile: empty tiles skipped with
    ``capacity=None``, zero-weighted (``valid`` False) with an int."""
    base = _PATCHED[strat]
    dh, dw = kw["dh"], kw["dw"]
    tiles = _tile_grid(img, dh, dw)[0]                      # (P, c, dh, dw)
    mtiles = _tile_grid(mask, dh, dw)[0][:, 0]              # (P, dh, dw)
    if base == "areaarea_mask_trans":
        # the _patch variant drops the centre column BEFORE the softmax
        # (loss_util.py:1040-1049), unlike plain mask_trans
        def row_fn(im, i, p):
            q = _drop_center_col(_rows_mask_trans_nosoftmax(im, i, p, kw), kw["kernel_size"])
            return _softmax(q) if kw["softmax"] else q
    else:
        def row_fn(im, i, p):
            return _MASKED[base](im, i, p, kw)
    s, valid = _rows_at(row_fn, tiles, mtiles, capacity)
    return SimMap(s=s[None], valid=valid)


def _mutual_patch(img_gt, img_sr, mask, kw, capacity):
    """GT rows per tile, and SR rows measured against the GT centre
    neighbourhood (loss_util.py:1059-1178: ``q = sr_search - GT_center``)."""
    ks, kc = kw["kernel_size"], kw["kernel_size_center"]
    sigma, softmax = kw["scaling_factor"], kw["softmax"]
    dh, dw = kw["dh"], kw["dw"]
    gt_tiles = _tile_grid(img_gt, dh, dw)[0]
    sr_tiles = _tile_grid(img_sr, dh, dw)[0]
    mtiles = _tile_grid(mask, dh, dw)[0][:, 0]
    c = gt_tiles.shape[1]

    def cross(sr_t, centre):
        return torch.sum((_tile_neighborhoods(sr_t, kc) - centre) ** 2, dim=1)

    def row_fn(im, i, p):
        # the GT centre window lies inside its tile: GT's rows are the raw SSD
        centres = _crop(im[:, 0], i, p, kc, kc // 2).reshape(len(i), -1, 1)
        qs = _by_chunks(cross, c * kc * kc * ks * ks, _gather_tiles(im[:, 1], i, p, ks),
                        centres)
        return (_exp_rows(_raw_ssd(im[:, 0], i, p, ks, kc), sigma, softmax),
                _exp_rows(qs, sigma, softmax))
    (qg, qs), valid = _rows_at(row_fn, torch.stack([gt_tiles, sr_tiles], dim=1), mtiles,
                               capacity)
    return SimMap(s=qg[None], s1=qs[None], valid=valid)


# ---------------------------------------------------------------------------
# the issl composition over any strategy
# ---------------------------------------------------------------------------

def simself_strategy_loss(sr, gt, mask, setting):
    """(l_selfsim, l_selfsim_kl) through any ``simself_strategy``: the
    reference's ``issl`` composition (ddpmssl.py:439-513), per-image maps of
    SR (``softmax_sr``) and of GT (``softmax_gt``, without grad), then the
    L1 mean and the KL.  An image whose (strided) mask is empty is
    zero-weighted, where the reference skips it, and the masked families'
    rows come at ``setting.capacity`` per image with validity weights, as in
    JAX: the value equals the reference's skip-and-concat whenever the
    capacity covers every image's edge pixels.

    sr, gt: NCHW (b, c, h, w) in [0, 1]; mask: (b, h, w) or (b, 1, h, w)."""
    opts = dict(setting.strategy_opts)
    kw = dict(
        dh=int(opts.get("simself_dh", 16)), dw=int(opts.get("simself_dw", 16)),
        kernel_size=int(opts.get("kernel_size", 25)),
        scaling_factor=opts.get("scaling_factor", 4),
        temperature=opts.get("temperature", 0),
        crossentropy=bool(opts.get("crossentropy", False)),
        rearrange_back=bool(opts.get("rearrange_back", True)),
        kernel_size_center=opts.get("kernel_size_center", 9),
        mean=bool(opts.get("mean", False)), var=bool(opts.get("var", False)),
        gene_type=opts.get("gene_type", "sum"),
        largest_k=int(opts.get("largest_k", 0)),
        stride=1, pix_num=1, index=None)
    softmax_sr = bool(opts.get("softmax_sr", False))
    softmax_gt = bool(opts.get("softmax_gt", False))

    if mask.dim() == 4:
        mask = mask[:, 0]
    mask = apply_mask_stride(mask, setting.mask_stride)
    kl = KLDistanceLoss(loss_weight=1.0, softmax=setting.kl_softmax)
    l1_num = kl_num = denom = 0.0
    for i in range(sr.shape[0]):
        m_i = mask[i][None, None]
        img_w = (torch.sum(m_i) > 0).to(sr.dtype)          # the reference's skip
        out = similarity_map(sr[i][None], mask=m_i, simself_strategy=setting.strategy,
                             capacity=setting.capacity, softmax=softmax_sr, **kw)
        with torch.no_grad():
            tgt = similarity_map(gt[i][None], mask=m_i, simself_strategy=setting.strategy,
                                 capacity=setting.capacity, softmax=softmax_gt, **kw).s
        if out.valid is not None:
            w = out.valid.to(sr.dtype)[None, :, None] * img_w
        else:
            w = img_w.expand(out.s.shape[:1] + (1,) * (out.s.dim() - 1))
        l1_num = l1_num + torch.sum(torch.abs(out.s - tgt) * w)
        kl_num = kl_num + torch.sum(kl.pointwise(out.s, tgt) * w)
        denom = denom + torch.sum(w * torch.ones_like(out.s))
    denom = denom + 1e-12
    return setting.l1_weight * l1_num / denom, setting.kl_weight * kl_num / denom


def judge_abnormal_pixel(sr, gt, kernel_size=3):
    """loss_util.py:1483-1519: pixels whose centre |SR - GT| exceeds 3x the
    neighbourhood's mean difference.  Returns (sr_abnormal, gt_abnormal,
    normal_mask, abnormal_mask), the masks boolean (b, c, h, w)."""
    b, c, h, w = sr.shape
    k = kernel_size
    su = _unfold(sr, k, padding=k // 2, pad_mode="reflect").reshape(b, c, k * k, h * w)
    gu = _unfold(gt, k, padding=k // 2, pad_mode="reflect").reshape(b, c, k * k, h * w)
    mid = k * k // 2
    d_mid = torch.abs(su[:, :, mid] - gu[:, :, mid])
    d_center = d_mid.sum(dim=1, keepdim=True)
    d_nbr = (torch.abs(su - gu).sum(dim=2) - d_mid).sum(dim=1, keepdim=True) / (k * k - 1)
    abnormal = (d_center > 3 * d_nbr).reshape(b, 1, h, w).expand(b, c, h, w)
    return sr[abnormal], gt[abnormal], ~abnormal, abnormal
