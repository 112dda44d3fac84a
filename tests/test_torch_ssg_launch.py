"""K1's launch geometry (ssl_tpu_torch/ops/ssg_cuda.py::k1_launch), on the CPU.

The kernel cannot run here, but the tiling that its grid and shared memory
follow is plain Python: the shipped search 25 / window 9 and the small 9 / 5
at the main paths' shapes (the ESRGAN step's b16, 3x128^2, the diffusion
mini-step's b2, 3x512^2 and the RealESRGAN-SSL step's b12, 3x400^2) and at
ragged ones.  The card checks that the
library agrees (the wrapper compares ``ssg_loss_fwd_blocks`` and
``ssg_loss_fwd_smem_bytes`` with it at every launch).  With the bf16 q
store, the stream kernel's grid (``k1_stream_launch``, checked against
``ssg_loss_fwd_stream_blocks``) and the walk's q stack, whose bytes are
what the stored route budgets (``losses/ssl_loss.py::q_store_bytes``)."""

import numpy as np
import pytest

from ssl_tpu_torch.losses.ssl_loss import dense_route, q_store_bytes
from ssl_tpu_torch.ops.ssg import SSGConfig
from ssl_tpu_torch.ops.ssg_cuda import (K1_WARPS, MAX_SMEM_BYTES, k1_launch, k1_stack_shape,
                                        k1_stream_launch)


@pytest.mark.parametrize("search,window", [(25, 9), (9, 5)])
@pytest.mark.parametrize("b,h,w", [(16, 128, 128), (2, 512, 512), (12, 400, 400), (2, 20, 20),
                                   (1, 50, 45)])
def test_k1_launch_covers_every_pixel_once(b, h, w, search, window):
    geom = k1_launch(b, 3, h, w, search, window)
    th, tw = geom.tile
    assert th + 2 * (window // 2) == 32 and tw == 32      # region rows and columns: one per lane
    assert geom.smem_bytes <= MAX_SMEM_BYTES
    assert geom.threads == 32 * K1_WARPS
    gx, gy, gz = geom.grid
    assert gz == b and geom.blocks == gx * gy * gz       # one row of `partial` per block
    covered = np.zeros((b, h, w), dtype=np.int64)
    for z in range(gz):
        for y in range(gy):
            for x in range(gx):
                covered[z, y * th:(y + 1) * th, x * tw:(x + 1) * tw] += 1
    assert (covered == 1).all()
    # no block lies wholly outside the image
    assert (gy - 1) * th < h and (gx - 1) * tw < w


def test_k1_launch_shared_memory_by_layout():
    """The shipped configuration's layout, in floats: staged images, C2 and
    its row sums, the maps and block sums, and eight warps' scratch."""
    images = 2 * 3 * (24 + 24) * 57
    region = 2 * 32 * 41 + 2 * 32 * 33
    maps = 5 * 24 * 32 + 3 * 8
    scratch = 8 * 2 * 32 * 41
    assert k1_launch(16, 3, 128, 128, 25, 9).smem_bytes == 4 * (images + region + maps + scratch)


def test_k1_launch_of_the_pairs_walk():
    """The bf16 stream + store mode's walk: the images as c planes of bf16x2
    (SR, GT) cells, only the inverse maps, 16 warps' scratch: 226,048 bytes,
    within what a block may take; the other modes keep the 8-warp layout."""
    images = 3 * (24 + 24) * 57
    region = 2 * 32 * 41 + 2 * 32 * 33
    maps = 2 * 24 * 32 + 3 * 16
    scratch = 16 * 2 * 32 * 41
    geom = k1_launch(24, 3, 128, 128, 25, 9, (1, 1))
    assert geom.smem_bytes == 4 * (images + region + maps + scratch) == 226_048
    assert geom.smem_bytes <= MAX_SMEM_BYTES and geom.threads == 512
    assert geom.grid == k1_launch(24, 3, 128, 128, 25, 9).grid
    for mode in ((0, 0), (1, 0), (0, 1)):
        assert k1_launch(24, 3, 128, 128, 25, 9, mode) == k1_launch(24, 3, 128, 128, 25, 9)


def test_k1_launch_refuses_windows_past_the_lanes():
    with pytest.raises(ValueError, match="windows up to 31"):
        k1_launch(1, 3, 128, 128, 33, 33)


@pytest.mark.parametrize("b,h,w", [(24, 128, 128), (16, 128, 128), (2, 20, 24), (1, 50, 45),
                                   (3, 7, 5)])
def test_k1_stream_launch_covers_every_pixel_once(b, h, w):
    """One thread a pixel in blocks of the walk's 256 threads; the last
    block's threads past the b h w pixels take no pixel."""
    geom = k1_stream_launch(b, h, w)
    assert geom.threads == 32 * K1_WARPS and geom.grid == (geom.blocks, 1, 1)
    pixels = np.arange(geom.blocks * geom.threads)
    covered = np.bincount(pixels[pixels < b * h * w], minlength=b * h * w)
    assert (covered == 1).all()
    assert (geom.blocks - 1) * geom.threads < b * h * w       # no block without a pixel


@pytest.mark.parametrize("b,h,w,search", [(24, 128, 128, 25), (16, 128, 128, 25),
                                          (2, 20, 24, 9), (48, 256, 256, 25)])
def test_k1_stack_is_what_the_stored_route_budgets(b, h, w, search):
    """The walk's stack, (search^2, b, h, w, 2) bf16, takes the bytes
    ``dense_route`` weighs for the bf16 stored route: 0.98 GB at bench.py's
    b24, 3x128^2, which takes that route; BSRGAN-SSL's b48, 3x256^2 does not."""
    cfg = SSGConfig(search=search, window=9 if search == 25 else 5, q_store_dtype="bfloat16")
    shape = k1_stack_shape(b, h, w, search)
    assert shape == (search * search, b, h, w, 2)
    assert 2 * np.prod(shape) == q_store_bytes(b, h, w, cfg)        # bf16: 2 bytes a value
    if (b, h) == (24, 128):
        assert 2 * np.prod(shape) == 983_040_000 and dense_route(b, h, w, cfg)[0]
    if b == 48:
        assert not dense_route(b, h, w, cfg)[0]
