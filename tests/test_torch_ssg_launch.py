"""K1's launch geometry (ssl_tpu_torch/ops/ssg_cuda.py::k1_launch), on the CPU.

The kernel cannot run here, but the tiling that its grid and shared memory
follow is plain Python: the shipped search 25 / window 9 and the small 9 / 5
at the main paths' shapes (the ESRGAN step's b16, 3x128^2, the diffusion
mini-step's b2, 3x512^2 and the RealESRGAN-SSL step's b12, 3x400^2) and at
ragged ones.  The card checks that the
library agrees (the wrapper compares ``ssg_loss_fwd_blocks`` and
``ssg_loss_fwd_smem_bytes`` with it at every launch)."""

import numpy as np
import pytest

from ssl_tpu_torch.ops.ssg_cuda import K1_WARPS, MAX_SMEM_BYTES, k1_launch


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


def test_k1_launch_refuses_windows_past_the_lanes():
    with pytest.raises(ValueError, match="windows up to 31"):
        k1_launch(1, 3, 128, 128, 33, 33)
