"""Self-Similarity Graph (SSG) loss semantics in plain PyTorch.

Counterpart of ``ssl_tpu/ops/ssg.py``.  For an image (c, h, w) and a binary
edge mask (h, w), reflect-pad by p = search//2.  For every pixel (y, x) and
every search offset d = (dy, dx) in [-p, p]^2 the windowed SSD over window
offsets (kh, kw) in [-k, k]^2 (k = window//2) is

    inside = (dy + kh in [-p, p]) and (dx + kw in [-p, p])
    term   = (P[c, y+p+kh, x+p+kw] - P[c, y+p+dy+kh, x+p+dx+kw])^2   if inside
           = (P[c, y+p+kh, x+p+kw])^2                                otherwise
    S_d(y, x) = sum_c sum_k term

then q_d = exp(-(S_d / (c * window^2)) / sigma), row-normalized over the
search^2 offsets when ``generalization`` is on.  The loss sums are masked
sum |x - y| and sum y (log y - log x) (clamp 1e-10) between the normalized
rows of SR and GT.

This module holds the plain version of the K1 kernel
(``ssl_loss_sums_reference``, the semantics of ``_ssl_loss_dense_core``) and
the analytic backward (``ssl_loss_dense_bwd``).  The plain forward serves CPU
tensors and is what the CUDA kernel in ``ssl_tpu_torch/csrc/ssg_loss_fwd.cu``
is held against; the backward is plain PyTorch on every device, as the JAX
package runs its backward in XLA outside any Pallas kernel.

Box-sums use the banded-matrix form of ``_dense_smap_b``: for offset d the
clipped window rectangle [a_y, b_y] x [a_x, b_x] is a 0/1 band matrix on each
side, and S_d = By (D_d - C2) Bx^T + box9(C2) with D_d = sum_c (P - P_d)^2
and C2 = sum_c P^2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class SSGConfig(NamedTuple):
    """Hyper-parameters of the SSG (defaults = every shipped config,
    ``options/train/ESRGANSSL/train_ESRGANSSL_bicubic_x4.yml:70-76``).

    ``q_store_dtype`` and ``stream_dtype`` accept only ``"float32"`` here;
    the bfloat16 variants are queued in ROADMAP.md."""

    search: int = 25
    window: int = 9
    sigma: float = 0.004
    generalization: bool = True
    q_store_dtype: str = "float32"
    stream_dtype: str = "float32"


def check_config(cfg: SSGConfig) -> None:
    """Raise on settings this port does not implement."""
    for name in ("q_store_dtype", "stream_dtype"):
        if getattr(cfg, name) != "float32":
            raise NotImplementedError(
                f"SSGConfig.{name}={getattr(cfg, name)!r}: only float32 is ported "
                "(bf16 SSG knobs are queued in ROADMAP.md)")
    if cfg.search % 2 == 0 or cfg.window % 2 == 0 or cfg.window > cfg.search:
        raise ValueError(f"search and window must be odd with window <= search, got {cfg}")


def reflect_pad_2d(img: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the trailing two dims (edge not repeated)."""
    lead = img.shape[:-2]
    flat = img.reshape((1, -1) + tuple(img.shape[-2:]))
    out = F.pad(flat, (pad, pad, pad, pad), mode="reflect")
    return out.reshape(tuple(lead) + tuple(out.shape[-2:]))


def reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source index in [0, n) of each of the n + 2*pad reflect-padded
    positions, as ``np.pad(mode="reflect")`` pads, also where pad >= n."""
    u = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(u)
    u = u.remainder(2 * (n - 1))
    return torch.where(u > n - 1, 2 * (n - 1) - u, u)


def reflect_pad_2d_adjoint(d_pad: torch.Tensor, pad: int) -> torch.Tensor:
    """Adjoint of ``reflect_pad_2d``: fold a padded gradient back onto the image."""
    hp, wp = d_pad.shape[-2], d_pad.shape[-1]
    h, w = hp - 2 * pad, wp - 2 * pad
    nd = d_pad.dim()
    rows = d_pad.new_zeros(d_pad.shape[:-2] + (h, wp))
    rows.index_add_(nd - 2, reflect_index(h, pad, d_pad.device), d_pad)
    out = d_pad.new_zeros(d_pad.shape[:-2] + (h, w))
    return out.index_add_(nd - 1, reflect_index(w, pad, d_pad.device), rows)


def apply_mask_stride(mask: torch.Tensor, stride: int) -> torch.Tensor:
    """Diagonal-lattice subsampling of an edge mask: keep (y, x) with
    y % stride == x % stride (reference ``esrganssl_model.py:56-63``).
    ``stride <= 1`` is the identity."""
    if stride <= 1:
        return mask
    h, w = mask.shape[-2], mask.shape[-1]
    yy = torch.arange(h, device=mask.device)[:, None]
    xx = torch.arange(w, device=mask.device)[None, :]
    return mask * ((yy % stride) == (xx % stride)).to(mask.dtype)


def _band_matrix(n_out: int, n_in: int, p: int, lo: int, hi: int, device) -> torch.Tensor:
    """0/1 band matrix B[y, u] = 1 iff lo <= u - (y + p) <= hi."""
    d = (torch.arange(n_in, device=device)[None, :]
         - torch.arange(n_out, device=device)[:, None] - p)
    return ((d >= lo) & (d <= hi)).to(torch.float32)


def _window_bounds(d: int, p: int, k: int) -> tuple[int, int]:
    """Clipped window rectangle [lo, hi] along one axis for shift d."""
    return max(-k, -p - d), min(k, p - d)


class _Context(NamedTuple):
    P: torch.Tensor        # (n, c, hp, wp) reflect-padded images
    Pbig: torch.Tensor     # (n, c, hp + 2p, wp + 2p): P with p more zeros each side
    center2: torch.Tensor  # (n, hp, wp) sum_c P^2
    box_c2: torch.Tensor   # (n, h, w) full window x window box of center2
    by: list               # per dy index: (h, hp) band of the clipped rectangle
    bx: list               # per dx index: (w, wp)


def _context(img: torch.Tensor, cfg: SSGConfig) -> _Context:
    p, k = cfg.search // 2, cfg.window // 2
    _, _, h, w = img.shape
    P = reflect_pad_2d(img, p)
    center2 = torch.sum(P * P, dim=1)
    dev = img.device
    box_c2 = (_band_matrix(h, h + 2 * p, p, -k, k, dev) @ center2
              @ _band_matrix(w, w + 2 * p, p, -k, k, dev).T)
    by = [_band_matrix(h, h + 2 * p, p, *_window_bounds(i - p, p, k), dev)
          for i in range(cfg.search)]
    bx = [_band_matrix(w, w + 2 * p, p, *_window_bounds(i - p, p, k), dev)
          for i in range(cfg.search)]
    return _Context(P, F.pad(P, (p, p, p, p)), center2, box_c2, by, bx)


def _smap(ctx: _Context, s: int, cfg: SSGConfig) -> torch.Tensor:
    """Raw windowed-SSD map (n, h, w) for search-offset index s."""
    iy, ix = divmod(s, cfg.search)                       # dy = iy - p, dx = ix - p
    hp, wp = ctx.P.shape[-2], ctx.P.shape[-1]
    shifted = ctx.Pbig[:, :, iy:iy + hp, ix:ix + wp]     # P shifted by (dy, dx)
    D = torch.sum((ctx.P - shifted) ** 2, dim=1)
    return ctx.by[iy] @ (D - ctx.center2) @ ctx.bx[ix].T + ctx.box_c2


def _q_maps(ctx: _Context, s: int, cfg: SSGConfig, norm: float, b: int):
    q = torch.exp(-(_smap(ctx, s, cfg) / norm) / cfg.sigma)
    return q[:b], q[b:]


def ssl_loss_sums_reference(sr: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                            cfg: SSGConfig = SSGConfig()):
    """Plain version of the fused SSL-loss forward (K1).

    sr, gt: (b, c, h, w) float32; mask: (b, h, w).  Returns
    ``(l1_sum, kl_sum, count, inv_sr, inv_gt, a_map, b_map)``: the masked loss
    sums over (pixels x offsets), the mask count, the (b, h, w)
    row-normalizers 1/(sum_d q_d + 1e-10) of SR and GT, and the backward
    helpers a_map = sum_d sign(x - y) x and b_map = sum_d y [x > 1e-10]
    (semantics of ``ssl_tpu/ops/ssg.py::_ssl_loss_dense_core``)."""
    check_config(cfg)
    b, c, h, w = sr.shape
    n2 = cfg.search * cfg.search
    norm = c * float(cfg.window) ** 2
    ctx = _context(torch.cat([sr, gt.detach()], dim=0), cfg)
    mask = mask.to(sr.dtype)
    count = torch.sum(mask)

    if cfg.generalization:
        r_sr = sr.new_zeros((b, h, w))
        r_gt = sr.new_zeros((b, h, w))
        for s in range(n2):
            q_sr, q_gt = _q_maps(ctx, s, cfg, norm, b)
            r_sr = r_sr + q_sr
            r_gt = r_gt + q_gt
        inv_sr = 1.0 / (r_sr + 1e-10)
        inv_gt = 1.0 / (r_gt + 1e-10)
    else:
        inv_sr = sr.new_ones((b, h, w))
        inv_gt = sr.new_ones((b, h, w))

    l1_sum = sr.new_zeros(())
    kl_sum = sr.new_zeros(())
    a_map = sr.new_zeros((b, h, w))
    b_map = sr.new_zeros((b, h, w))
    for s in range(n2):
        q_sr, q_gt = _q_maps(ctx, s, cfg, norm, b)
        x = q_sr * inv_sr
        y = q_gt * inv_gt
        l1_sum = l1_sum + torch.sum(mask * torch.abs(x - y))
        xs = torch.clamp(x, min=1e-10)
        ys = torch.clamp(y, min=1e-10)
        kl_sum = kl_sum + torch.sum(mask * (ys * (torch.log(ys) - torch.log(xs))))
        a_map = a_map + torch.sign(x - y) * x
        b_map = b_map + y * (x > 1e-10)
    return l1_sum, kl_sum, count, inv_sr, inv_gt, a_map, b_map


def ssl_loss_dense_bwd(sr, gt, mask, inv_sr, inv_gt, g_l1, g_kl,
                       cfg: SSGConfig = SSGConfig(), a_map=None, b_map=None):
    """Analytic gradient of (g_l1 * l1_sum + g_kl * kl_sum) w.r.t. sr
    (port of ``ssl_tpu/ops/ssg.py::ssl_loss_dense_bwd``; gt is a constant).

    With x = q_sr * inv_sr and y = q_gt * inv_gt:
      g_d  = mask * (g_l1 * sign(x - y) - g_kl * y / x)
      G_d  = (inv * g_d - inv^2 * T) * q_d * (-1 / (norm * sigma)),
      T    = sum_d g_d q_d   (from a_map/b_map when given, else one offset pass)
      A_d  = By^T G_d Bx,  shiftA_d = A_d shifted by d (band bounds moved by d)
      dP   = 2 [ P (sum_d shiftA_d + box9^T(sum_d G_d)) - sum_d (A_d P_d + shiftA_d P_-d) ]
    and the reflect-pad adjoint folds dP back onto the image."""
    check_config(cfg)
    b, c, h, w = sr.shape
    search = cfg.search
    p, k = search // 2, cfg.window // 2
    n2 = search * search
    norm = c * float(cfg.window) ** 2
    scale = -1.0 / (norm * cfg.sigma)
    ctx = _context(torch.cat([sr, gt], dim=0), cfg)
    P, Pbig = ctx.P[:b], ctx.Pbig[:b]
    hp, wp = P.shape[-2], P.shape[-1]
    mask = mask.to(sr.dtype)
    dev = sr.device

    def g_of(q_sr, q_gt):
        x = q_sr * inv_sr
        y = q_gt * inv_gt
        kl_term = torch.where(x > 1e-10, -y / torch.clamp(x, min=1e-10), torch.zeros_like(x))
        return mask * (g_l1 * torch.sign(x - y) + g_kl * kl_term)

    if not cfg.generalization:
        T = sr.new_zeros((b, h, w))
    elif a_map is not None:
        T = (1.0 / inv_sr) * mask * (g_l1 * a_map - g_kl * b_map)
    else:
        T = sr.new_zeros((b, h, w))
        for s in range(n2):
            q_sr, q_gt = _q_maps(ctx, s, cfg, norm, b)
            T = T + g_of(q_sr, q_gt) * q_sr

    # band transposes of the shifted rectangles, per dy / dx index
    by_s = [_band_matrix(h, hp, p, *(v + i - p for v in _window_bounds(i - p, p, k)), dev)
            for i in range(search)]
    bx_s = [_band_matrix(w, wp, p, *(v + i - p for v in _window_bounds(i - p, p, k)), dev)
            for i in range(search)]

    acc1 = sr.new_zeros((b, c, hp, wp))
    sum_shift_a = sr.new_zeros((b, hp, wp))
    sum_g = sr.new_zeros((b, h, w))
    for s in range(n2):
        iy, ix = divmod(s, search)
        q_sr, q_gt = _q_maps(ctx, s, cfg, norm, b)
        G_d = (inv_sr * g_of(q_sr, q_gt) - inv_sr * inv_sr * T) * q_sr * scale
        A_d = ctx.by[iy].T @ G_d @ ctx.bx[ix]
        shift_a = by_s[iy].T @ G_d @ bx_s[ix]
        P_pd = Pbig[:, :, iy:iy + hp, ix:ix + wp]
        P_md = Pbig[:, :, 2 * p - iy:2 * p - iy + hp, 2 * p - ix:2 * p - ix + wp]
        acc1 = acc1 + A_d[:, None] * P_pd + shift_a[:, None] * P_md
        sum_shift_a = sum_shift_a + shift_a
        sum_g = sum_g + G_d

    a9 = (_band_matrix(h, hp, p, -k, k, dev).T @ sum_g @ _band_matrix(w, wp, p, -k, k, dev))
    dP = 2.0 * ((sum_shift_a + a9)[:, None] * P - acc1)
    return reflect_pad_2d_adjoint(dP, p)
