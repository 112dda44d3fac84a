"""Height-sharded SR inference.

Counterpart of ``ssl_tpu/parallel/spatial.py``, where ``shard_map`` splits
the image height over a device mesh and ``lax.ppermute`` moves the halos.
Here every rank is given the whole image, so each one slices its own
``s + 2 * halo``-row window (its band of ``s`` rows and the halo rows its
neighbours would send) straight from it, runs the net on the window and
keeps its ``s * scale`` output rows; ``all_gather`` assembles the image on
every rank.

The window and crop rules are those of the JAX function (its :60-92): a band
at the image's top or bottom keeps the true border at its window's edge (the
net's own padding applies, as in a whole-image pass), an interior band takes
``halo`` rows from each side, the height is reflect-padded to a multiple of
the band count, and an image too small for the ranks runs whole.  With
``halo`` at least the net's receptive-field radius the result equals the
whole-image pass."""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ssl_tpu_torch.parallel.mesh import get_dist_info


def spatial_infer(apply_fn, img: torch.Tensor, scale: int, halo: int = 32,
                  group=None) -> torch.Tensor:
    """SR of the (b, c, H, W) ``img`` (the same on every rank) with H sharded
    over the ranks of ``group`` (the world by default); ``apply_fn(x)`` maps
    (b, c, h, w) to (b, c, h * scale, w * scale).  Returns the whole
    (b, c, H * scale, W * scale) result on every rank."""
    if group is None:
        rank, n = get_dist_info()
    else:
        rank, n = dist.get_rank(group), dist.get_world_size(group)
    if n == 1:
        return apply_fn(img)
    halo = int(halo)
    if halo < 1:
        raise ValueError("spatial_infer needs halo >= 1")
    h_img = img.shape[2]
    s = max(math.ceil(h_img / n), 2 * halo)      # halos from the neighbour bands alone
    hp = s * n
    if hp - h_img >= h_img:
        # too small for these ranks and this halo: the bands would mostly
        # hold reflect padding, so every rank runs it whole
        return apply_fn(img)
    if hp != h_img:
        img = F.pad(img, (0, 0, 0, hp - h_img), mode="reflect")
    # rows kept above the own band: none at the top, 2 halo at the bottom,
    # halo in between
    top = 0 if rank == 0 else (2 * halo if rank == n - 1 else halo)
    win = img[:, :, rank * s - top:rank * s - top + s + 2 * halo]
    y = apply_fn(win)[:, :, top * scale:(top + s) * scale].contiguous()
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts, dim=2)[:, :, :h_img * scale]
