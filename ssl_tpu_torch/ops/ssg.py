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
(``ssl_loss_sums_reference``, the semantics of ``_ssl_loss_dense_core``; with
the bf16 q store, of its two kernels: ``q_stack_reference`` for the walk and
``q_stream_reference`` for the stream) and the analytic backward
(``ssl_loss_dense_bwd``).  The plain forward serves CPU
tensors and is what the CUDA kernel in ``ssl_tpu_torch/csrc/ssg_loss_fwd.cu``
is held against; the backward is plain PyTorch on every device, as the JAX
package runs its backward in XLA outside any Pallas kernel.

Box-sums use the banded-matrix form of ``_dense_smap_b``: for offset d the
clipped window rectangle [a_y, b_y] x [a_x, b_x] is a 0/1 band matrix on each
side, and S_d = By (D_d - C2) Bx^T + box9(C2) with D_d = sum_c (P - P_d)^2
and C2 = sum_c P^2.

The bf16 knobs of ``SSGConfig`` round at the JAX package's points:

* ``stream_dtype="bfloat16"`` (``_dense_context_b``, ``_dense_smap_b``): C2
  and box9(C2) come from the float32 padded image; P and its shifted copies
  are rounded to bf16, and D sums over the channels in float32 the squares of
  the bf16-rounded differences (what XLA compiles ``jnp.sum((P - P_d) ** 2,
  dtype=float32)`` on bf16 operands to: it keeps the square in float32).  The
  backward streams the same rounded slices; its epilogue dP = 2((sum shiftA
  + A9) P - acc1) takes the float32 P on the stored route and the rounded P
  on the batched one, as the two JAX routes do.
* ``q_store_dtype="bfloat16"`` (``_q_stack``, ``_q_decode``; the stored route
  only): the row sums take the float32 q; everything after them (x, y, the
  loss sums, a_map, b_map and the backward) takes the decoded pair q_sr' =
  bf16(q_sr), q_gt' = max(q_sr' - bf16(q_sr - q_gt), 0).

``losses/ssl_loss.py::dense_route`` chooses the route by the JAX package's
rule; on the batched route the store knob has no effect.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


class SSGConfig(NamedTuple):
    """Hyper-parameters of the SSG (defaults = every shipped config,
    ``options/train/ESRGANSSL/train_ESRGANSSL_bicubic_x4.yml:70-76``).
    ``q_store_dtype`` and ``stream_dtype`` take ``"float32"`` or
    ``"bfloat16"`` (see the module docstring)."""

    search: int = 25
    window: int = 9
    sigma: float = 0.004
    generalization: bool = True
    q_store_dtype: str = "float32"
    stream_dtype: str = "float32"


BF16 = "bfloat16"


def check_config(cfg: SSGConfig) -> None:
    """Raise on settings this port does not implement."""
    for name in ("q_store_dtype", "stream_dtype"):
        if getattr(cfg, name) not in ("float32", BF16):
            raise NotImplementedError(
                f"SSGConfig.{name}={getattr(cfg, name)!r}: the port takes float32 or bfloat16")
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


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest bf16 value (ties to even), in its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _q_decode(q_sr: torch.Tensor, q_gt: torch.Tensor, cfg: SSGConfig):
    """The q pair as the stored route reads it back (``ssl_tpu/ops/ssg.py::
    _q_stack``, ``_q_decode``): with the bf16 store, q_sr rounded and q_gt
    from the rounded difference q_sr - q_gt, clipped at 0."""
    if cfg.q_store_dtype != BF16:
        return q_sr, q_gt
    first = round_bf16(q_sr)
    return first, torch.clamp(first - round_bf16(q_sr - q_gt), min=0.0)


def _band_matrix(n_out: int, n_in: int, p: int, lo: int, hi: int, device,
                 dtype=torch.float32) -> torch.Tensor:
    """0/1 band matrix B[y, u] = 1 iff lo <= u - (y + p) <= hi."""
    d = (torch.arange(n_in, device=device)[None, :]
         - torch.arange(n_out, device=device)[:, None] - p)
    return ((d >= lo) & (d <= hi)).to(dtype)


def _window_bounds(d: int, p: int, k: int) -> tuple[int, int]:
    """Clipped window rectangle [lo, hi] along one axis for shift d."""
    return max(-k, -p - d), min(k, p - d)


class _Context(NamedTuple):
    P: torch.Tensor        # (n, c, hp, wp) reflect-padded images, in the stream's values
    Pbig: torch.Tensor     # (n, c, hp + 2p, wp + 2p): P with p more zeros each side
    center2: torch.Tensor  # (n, hp, wp) sum_c P^2 of the float32 P
    stream_bf16: bool      # D from bf16-rounded differences
    box_c2: torch.Tensor   # (n, h, w) full window x window box of center2
    by: list               # per dy index: (h, hp) band of the clipped rectangle
    bx: list               # per dx index: (w, wp)


def _context(img: torch.Tensor, cfg: SSGConfig) -> _Context:
    p, k = cfg.search // 2, cfg.window // 2
    _, _, h, w = img.shape
    P = reflect_pad_2d(img, p)
    center2 = torch.sum(P * P, dim=1)
    dev, dt = img.device, img.dtype
    box_c2 = (_band_matrix(h, h + 2 * p, p, -k, k, dev, dt) @ center2
              @ _band_matrix(w, w + 2 * p, p, -k, k, dev, dt).T)
    by = [_band_matrix(h, h + 2 * p, p, *_window_bounds(i - p, p, k), dev, dt)
          for i in range(cfg.search)]
    bx = [_band_matrix(w, w + 2 * p, p, *_window_bounds(i - p, p, k), dev, dt)
          for i in range(cfg.search)]
    stream_bf16 = cfg.stream_dtype == BF16
    if stream_bf16:
        P = round_bf16(P)
    return _Context(P, F.pad(P, (p, p, p, p)), center2, stream_bf16, box_c2, by, bx)


def _smap(ctx: _Context, s: int, cfg: SSGConfig) -> torch.Tensor:
    """Raw windowed-SSD map (n, h, w) for search-offset index s."""
    iy, ix = divmod(s, cfg.search)                       # dy = iy - p, dx = ix - p
    hp, wp = ctx.P.shape[-2], ctx.P.shape[-1]
    shifted = ctx.Pbig[:, :, iy:iy + hp, ix:ix + wp]     # P shifted by (dy, dx)
    diff = ctx.P - shifted
    if ctx.stream_bf16:
        diff = round_bf16(diff)
    D = torch.sum(diff * diff, dim=1)
    return ctx.by[iy] @ (D - ctx.center2) @ ctx.bx[ix].T + ctx.box_c2


def _q_maps(ctx: _Context, s: int, cfg: SSGConfig, norm: float, b: int):
    q = torch.exp(-(_smap(ctx, s, cfg) / norm) / cfg.sigma)
    return q[:b], q[b:]


def _offset_terms(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
    """One offset's share of the loss sums and maps from its normalized rows:
    sum mask |x - y|, sum mask y (log y - log x) (clamp 1e-10), sign(x - y) x
    and y [x > 1e-10]."""
    l1 = torch.sum(mask * torch.abs(x - y))
    xs = torch.clamp(x, min=1e-10)
    ys = torch.clamp(y, min=1e-10)
    kl = torch.sum(mask * (ys * (torch.log(ys) - torch.log(xs))))
    return l1, kl, torch.sign(x - y) * x, y * (x > 1e-10)


def q_stack_reference(sr: torch.Tensor, gt: torch.Tensor, cfg: SSGConfig = SSGConfig()):
    """Plain version of K1's walk (the bf16 q store's sweep 1): the q stack
    and the inverse maps.

    sr, gt: (b, c, h, w) float32.  Returns ``(stack, inv_sr, inv_gt)``: the
    stack a (search^2, b, h, w, 2) bf16 tensor, offset-major, holding at each
    pixel-offset bf16(q_sr) and bf16(q_sr - q_gt), the difference taken in
    float32 (``ssl_tpu/ops/ssg.py::_q_stack``'s encoding); inv_sr and inv_gt
    1 / (sum_d q_d + 1e-10) of the float32 q before any rounding (ones without
    ``generalization``).  The store knob is taken as bf16 whatever ``cfg``
    says; ``stream_dtype`` applies."""
    check_config(cfg)
    b, c, h, w = sr.shape
    norm = c * float(cfg.window) ** 2
    ctx = _context(torch.cat([sr, gt.detach()], dim=0), cfg)
    stack = torch.empty((cfg.search ** 2, b, h, w, 2), dtype=torch.bfloat16, device=sr.device)
    r_sr = sr.new_zeros((b, h, w))
    r_gt = sr.new_zeros((b, h, w))
    for s in range(cfg.search ** 2):
        q_sr, q_gt = _q_maps(ctx, s, cfg, norm, b)
        r_sr = r_sr + q_sr
        r_gt = r_gt + q_gt
        stack[s, ..., 0] = q_sr
        stack[s, ..., 1] = q_sr - q_gt
    if not cfg.generalization:
        return stack, sr.new_ones((b, h, w)), sr.new_ones((b, h, w))
    return stack, 1.0 / (r_sr + 1e-10), 1.0 / (r_gt + 1e-10)


def q_stream_reference(stack: torch.Tensor, inv_sr: torch.Tensor, inv_gt: torch.Tensor,
                       mask: torch.Tensor):
    """Plain version of K1's stream (the bf16 q store's sweep 2) over the
    walk's ``stack`` (``q_stack_reference``): each pixel-offset decoded as
    q_sr' = its first value, q_gt' = max(q_sr' - its second, 0)
    (``_q_decode``), x = q_sr' inv_sr, y = q_gt' inv_gt.  Returns
    ``(l1_sum, kl_sum, count, a_map, b_map)`` as ``ssl_loss_sums_reference``
    gives them, in its order of summation, so that the walk's and the
    stream's plain versions together equal it in the bf16 store modes."""
    mask = mask.to(inv_sr.dtype)
    l1_sum = inv_sr.new_zeros(())
    kl_sum = inv_sr.new_zeros(())
    a_map = inv_sr.new_zeros(inv_sr.shape)
    b_map = inv_sr.new_zeros(inv_sr.shape)
    for pair in stack:
        first = pair[..., 0].to(inv_sr.dtype)
        q_gt = torch.clamp(first - pair[..., 1].to(inv_sr.dtype), min=0.0)
        l1, kl, a, b = _offset_terms(first * inv_sr, q_gt * inv_gt, mask)
        l1_sum = l1_sum + l1
        kl_sum = kl_sum + kl
        a_map = a_map + a
        b_map = b_map + b
    return l1_sum, kl_sum, torch.sum(mask), a_map, b_map


def ssl_loss_sums_reference(sr: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                            cfg: SSGConfig = SSGConfig()):
    """Plain version of the fused SSL-loss forward (K1).

    sr, gt: (b, c, h, w) float32 (float64 for a float64 reference); mask:
    (b, h, w).  Returns
    ``(l1_sum, kl_sum, count, inv_sr, inv_gt, a_map, b_map)``: the masked loss
    sums over (pixels x offsets), the mask count, the (b, h, w)
    row-normalizers 1/(sum_d q_d + 1e-10) of SR and GT, and the backward
    helpers a_map = sum_d sign(x - y) x and b_map = sum_d y [x > 1e-10]
    (semantics of ``ssl_tpu/ops/ssg.py::_ssl_loss_dense_core``, and with the
    bf16 store of ``_ssl_loss_dense_core_stored``)."""
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
        q_sr, q_gt = _q_decode(*_q_maps(ctx, s, cfg, norm, b), cfg)
        l1, kl, a, b_ = _offset_terms(q_sr * inv_sr, q_gt * inv_gt, mask)
        l1_sum = l1_sum + l1
        kl_sum = kl_sum + kl
        a_map = a_map + a
        b_map = b_map + b_
    return l1_sum, kl_sum, count, inv_sr, inv_gt, a_map, b_map


def ssl_loss_dense_bwd(sr, gt, mask, inv_sr, inv_gt, g_l1, g_kl,
                       cfg: SSGConfig = SSGConfig(), a_map=None, b_map=None,
                       stored: bool = False):
    """Analytic gradient of (g_l1 * l1_sum + g_kl * kl_sum) w.r.t. sr
    (port of ``ssl_tpu/ops/ssg.py::ssl_loss_dense_bwd``, and with ``stored``
    of ``_ssl_dense_bwd_stored``, which differs from it only in its bf16
    modes: the decoded q pair, and the float32 P in the epilogue; gt is a
    constant).  It recomputes q for each offset where the JAX stored route
    reads its stack back.

    With x = q_sr * inv_sr and y = q_gt * inv_gt:
      g_d  = mask * (g_l1 * sign(x - y) - g_kl * y / x)
      G_d  = (inv * g_d - inv^2 * T) * q_d * (-1 / (norm * sigma)),
      T    = sum_d g_d q_d   (from a_map/b_map when given, else one offset pass)
      A_d  = By^T G_d Bx,  shiftA_d = A_d shifted by d (band bounds moved by d)
      dP   = 2 [ P (sum_d shiftA_d + box9^T(sum_d G_d)) - sum_d (A_d P_d + shiftA_d P_-d) ]
    and the reflect-pad adjoint folds dP back onto the image."""
    check_config(cfg)
    if cfg.q_store_dtype == BF16 and not stored:
        raise ValueError("q_store_dtype bfloat16 applies to the stored route only")
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
    dev, dt = sr.device, sr.dtype

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
            q_sr, q_gt = _q_decode(*_q_maps(ctx, s, cfg, norm, b), cfg)
            T = T + g_of(q_sr, q_gt) * q_sr

    # band transposes of the shifted rectangles, per dy / dx index
    by_s = [_band_matrix(h, hp, p, *(v + i - p for v in _window_bounds(i - p, p, k)), dev, dt)
            for i in range(search)]
    bx_s = [_band_matrix(w, wp, p, *(v + i - p for v in _window_bounds(i - p, p, k)), dev, dt)
            for i in range(search)]

    acc1 = sr.new_zeros((b, c, hp, wp))
    sum_shift_a = sr.new_zeros((b, hp, wp))
    sum_g = sr.new_zeros((b, h, w))
    for s in range(n2):
        iy, ix = divmod(s, search)
        q_sr, q_gt = _q_decode(*_q_maps(ctx, s, cfg, norm, b), cfg)
        G_d = (inv_sr * g_of(q_sr, q_gt) - inv_sr * inv_sr * T) * q_sr * scale
        A_d = ctx.by[iy].T @ G_d @ ctx.bx[ix]
        shift_a = by_s[iy].T @ G_d @ bx_s[ix]
        P_pd = Pbig[:, :, iy:iy + hp, ix:ix + wp]
        P_md = Pbig[:, :, 2 * p - iy:2 * p - iy + hp, 2 * p - ix:2 * p - ix + wp]
        acc1 = acc1 + A_d[:, None] * P_pd + shift_a[:, None] * P_md
        sum_shift_a = sum_shift_a + shift_a
        sum_g = sum_g + G_d

    a9 = (_band_matrix(h, hp, p, -k, k, dev, dt).T @ sum_g
          @ _band_matrix(w, wp, p, -k, k, dev, dt))
    if stored:
        P = reflect_pad_2d(sr, p)                        # the float32 P (JAX's stored routes)
    dP = 2.0 * ((sum_shift_a + a9)[:, None] * P - acc1)
    return reflect_pad_2d_adjoint(dP, p)


# ---------------------------------------------------------------------------
# The gather API: SSG rows at given edge positions
# ---------------------------------------------------------------------------
# Counterpart of ``ssl_tpu/ops/ssg.py::mask_to_positions``, ``ssg_ssd_maps_scan``,
# ``ssg_epilogue``, ``ssg_matrix`` and ``ssg_from_mask``: the reference's (N,
# search^2) SSG-matrix API, which ``impl: scan``, ``selfsim1_opt.softmax`` and
# the diffusion tree's strategy zoo use.  Plain PyTorch, as JAX writes it in
# XLA (no Pallas kernel computes it there either: ``ssg_pallas.py::
# ssg_ssd_maps_pallas`` runs the same scan).
#
# Where JAX scans the offsets one at a time with prefix sums, this computes the
# dense raw-SSD maps of a chunk of whole search rows at once and gathers the
# positions from them.  For offset d the window sum splits into disjoint parts,
# each a sum of non-negative terms (no cancelling prefix or box differences):
#
#   S_d = sum_{kh in Ry} [ sum_{kw in Rx} D_d + sum_{kw notin Rx} C2 ]
#         + sum_{kh notin Ry} sum_{kw} C2
#
# with [Ry] x [Rx] the clipped window rectangle of d, D_d = sum_c (P - P_d)^2
# and C2 = sum_c P^2; each sum over kw (kh) is a 1 x window (window x 1)
# grouped convolution with a 0/1 kernel per offset.  A chunk holds as many
# search rows as ``SSD_CHUNK_BYTES`` allow, and under autograd it is
# recomputed in the backward (``torch.utils.checkpoint``), as JAX bounds its
# memory with ``jax.checkpoint(body)``: only the gathered rows are kept.

SSD_CHUNK_BYTES = 1 << 30


def mask_to_positions(mask: torch.Tensor, capacity: int):
    """Binary (h, w) mask -> fixed-capacity row-major positions.

    Returns (pos, valid, count): pos (capacity, 2) int32 (y, x) with padding
    rows (0, 0); valid (capacity,) bool; count () int32, the true number of
    edge pixels, which may exceed capacity: then the first ``capacity`` in
    row-major order (``torch.nonzero``'s, as the reference wrapper's
    ``similaritywrapper.py:67``) are kept and the rest dropped."""
    w = mask.shape[-1]
    flat = mask.reshape(-1) == 1
    idx = torch.nonzero(flat)[:capacity, 0]
    n = idx.numel()
    pos = torch.zeros((capacity, 2), dtype=torch.int32, device=mask.device)
    pos[:n, 0] = (idx // w).to(torch.int32)
    pos[:n, 1] = (idx % w).to(torch.int32)
    valid = torch.arange(capacity, device=mask.device) < n
    return pos, valid, flat.sum(dtype=torch.int32)


def _rect_kernels(iy0: int, iy1: int, search: int, window: int, device, dtype):
    """0/1 kernels of the offsets of search rows [iy0, iy1), row-major: the
    columns inside (``kx_in``) and outside (``kx_out``) each offset's clipped
    rectangle, (N, 1, 1, window), and its rows likewise, (N, 1, window, 1)."""
    p, k = search // 2, window // 2
    t = torch.arange(-k, k + 1, device=device)

    def inside(i):
        lo, hi = _window_bounds(i - p, p, k)
        return ((t >= lo) & (t <= hi)).to(dtype)
    rows = torch.stack([inside(i) for i in range(iy0, iy1)])            # (R, window)
    cols = torch.stack([inside(i) for i in range(search)])              # (S, window)
    n = (iy1 - iy0) * search
    kx = cols.repeat(iy1 - iy0, 1).reshape(n, 1, 1, window)
    ky = rows.repeat_interleave(search, 0).reshape(n, 1, window, 1)
    return kx, 1.0 - kx, ky, 1.0 - ky


def _ssd_chunk(P, Pbig, iy0: int, iy1: int, flat_pos, search: int, window: int):
    """Raw SSDs of the offsets of search rows [iy0, iy1) at ``flat_pos``
    (m, n) flat pixel indices: (m, n, (iy1 - iy0) * search)."""
    p, k = search // 2, window // 2
    m, c, hp, wp = P.shape
    h, w = hp - 2 * p, wp - 2 * p
    h2, w2 = h + 2 * k, w + 2 * k
    centre = P[:, :, p - k:p + h + k, p - k:p + w + k]                 # (m, c, h2, w2)
    # cand[:, :, r, j, u, v] = Pbig[:, :, p - k + iy0 + r + u, p - k + j + v]: P
    # shifted by (iy0 + r - p, j - p), zeros outside the padded image
    cand = (Pbig[:, :, p - k + iy0:p - k + iy1 + h2 - 1, p - k:p + w + k + 2 * p]
            .unfold(2, h2, 1).unfold(3, w2, 1))                          # (m, c, R, S, h2, w2)
    diff = centre[:, :, None, None] - cand
    n_off = (iy1 - iy0) * search
    D = torch.sum(diff * diff, dim=1).reshape(m, n_off, h2, w2)
    c2 = torch.sum(centre * centre, dim=1, keepdim=True)                 # (m, 1, h2, w2)
    kx_in, kx_out, ky_in, ky_out = _rect_kernels(iy0, iy1, search, window, P.device, P.dtype)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False              # 0/1 sums: no input rounding
    try:
        e = F.conv2d(D, kx_in, groups=n_off) + F.conv2d(c2, kx_out)     # (m, N, h2, w)
        full = F.conv2d(c2, torch.ones_like(kx_in[:1]))                 # (m, 1, h2, w)
        s = F.conv2d(e, ky_in, groups=n_off) + F.conv2d(full, ky_out)   # (m, N, h, w)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    idx = flat_pos[:, None, :].expand(m, n_off, flat_pos.shape[1])
    return torch.gather(s.reshape(m, n_off, h * w), 2, idx).transpose(1, 2)


def ssd_rows(imgs: torch.Tensor, pos: torch.Tensor, search: int, window: int) -> torch.Tensor:
    """Raw windowed SSDs of each image at its positions: imgs (m, c, h, w),
    pos (m, n, 2) (y, x) -> (m, n, search^2), offsets row-major; candidate
    pixels outside the search patch read as zero (``ssg_ssd_maps_scan``'s
    function for a batch of images)."""
    if search % 2 == 0 or window % 2 == 0 or window > search:
        raise ValueError(f"search and window must be odd with window <= search, "
                         f"got {search}, {window}")
    p = search // 2
    m, c, h, w = imgs.shape
    P = reflect_pad_2d(imgs, p)
    Pbig = F.pad(P, (p, p, p, p))
    flat_pos = pos[..., 0].long() * w + pos[..., 1].long()
    k = window // 2
    row_bytes = m * (c + 3) * search * (h + 2 * k) * (w + 2 * k) * imgs.element_size()
    rows = max(1, min(search, SSD_CHUNK_BYTES // max(row_bytes, 1)))
    grad = torch.is_grad_enabled() and imgs.requires_grad
    out = []
    for iy0 in range(0, search, rows):
        args = (P, Pbig, iy0, min(iy0 + rows, search), flat_pos, search, window)
        out.append(checkpoint(_ssd_chunk, *args, use_reentrant=False) if grad
                   else _ssd_chunk(*args))
    return torch.cat(out, dim=2)


def ssg_ssd_maps_scan(img: torch.Tensor, cfg: SSGConfig, pos: torch.Tensor) -> torch.Tensor:
    """Gathered raw SSD values for each (edge pixel, search offset): img (c,
    h, w), pos (cap, 2) -> (cap, search^2), before the division by c *
    window^2 and the exp."""
    return ssd_rows(img[None], pos[None], cfg.search, cfg.window)[0]


def ssg_epilogue(ssd: torch.Tensor, num_ch: int, cfg: SSGConfig) -> torch.Tensor:
    """ssd (..., search^2) raw -> similarity rows q, row-normalized with
    ``generalization`` (sum + 1e-10)."""
    q = torch.exp(-(ssd / (num_ch * float(cfg.window) ** 2)) / cfg.sigma)
    if cfg.generalization:
        q = q / (torch.sum(q, dim=-1, keepdim=True) + 1e-10)
    return q


def ssg_matrix(img: torch.Tensor, pos: torch.Tensor, cfg: SSGConfig = SSGConfig()) -> torch.Tensor:
    """SSG rows for given edge positions: img (c, h, w) or a batch (m, c, h,
    w) with pos (cap, 2) or (m, cap, 2) -> (cap, search^2) or (m, cap,
    search^2).  Rows of padding positions are those of pixel (0, 0): mask
    them with the validity mask.  The JAX package's ``impl`` argument
    ('scan', 'pallas', 'dense') picks among implementations of this one
    function, so the port takes none."""
    if img.dim() == 3:
        return ssg_epilogue(ssg_ssd_maps_scan(img, cfg, pos), img.shape[0], cfg)
    return ssg_epilogue(ssd_rows(img, pos, cfg.search, cfg.window), img.shape[1], cfg)


def ssg_from_mask(img: torch.Tensor, mask: torch.Tensor, capacity: int,
                  cfg: SSGConfig = SSGConfig()):
    """(q, valid, count) of image (c, h, w) from a binary (h, w) mask."""
    pos, valid, count = mask_to_positions(mask, capacity)
    return ssg_matrix(img, pos, cfg), valid, count
