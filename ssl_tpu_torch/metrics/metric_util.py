"""What the deep metrics share: float32 scoring with TF32 off, and HWC
[0, 255] images as NCHW tensors.

The train and serve steps run cuDNN with TF32 on; a reported score should
not depend on that, so every deep metric scores inside ``exact_float32``."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def exact_float32():
    """cuDNN's and cuBLAS's TF32 off inside the block, restored after it;
    cuDNN itself stays on."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def image_tensor(img, crop_border: int, device) -> torch.Tensor:
    """HWC [0, 255] RGB (uint8 or float) -> (1, 3, h, w) in [0, 1] on
    ``device``, ``crop_border`` pixels cut from each edge.  A uint8 image
    travels as uint8 and is converted on the device; the division by 255 is
    float32 either way, correctly rounded, so the values are the JAX
    package's host float32 ones."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = a.astype(np.float32)
    if crop_border:
        a = a[crop_border:-crop_border, crop_border:-crop_border]
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t.permute(2, 0, 1)[None].float() / 255.0).contiguous()
