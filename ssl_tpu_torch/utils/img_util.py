"""Image IO and conversion (reference surface: utils/img_util.py).

Counterpart of ``ssl_tpu/utils/img_util.py``.  Files decode to HWC BGR uint8
(``cv2``'s convention) and convert to HWC RGB float32 [0, 1] arrays, which
``img2tensor`` turns into the CHW tensors the port's datasets give.

Decoding and encoding use ``cv2`` where it imports, as the JAX package does.
Without ``cv2``, PNG goes through ``utils/png.py``, which gives ``cv2``'s
result bit for bit; any other format then raises ``ImportError``."""

from __future__ import annotations

import os

import numpy as np
import torch

from ssl_tpu_torch.utils import png

_NO_CV2 = "cv2 is not installed: only PNG images can be read and written without it"


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def imfrombytes(content: bytes, flag: str = "color", float32: bool = False) -> np.ndarray:
    """Decode image bytes -> HWC BGR uint8 (cv2 convention), like the reference."""
    cv2 = _cv2()
    if cv2 is not None:
        imread_flags = {"color": cv2.IMREAD_COLOR, "grayscale": cv2.IMREAD_GRAYSCALE,
                        "unchanged": cv2.IMREAD_UNCHANGED}
        img = cv2.imdecode(np.frombuffer(content, np.uint8), imread_flags[flag])
    elif png.is_png(content):
        img = png.decode_png(content, flag)
    else:
        raise ImportError(_NO_CV2)
    if float32:
        img = img.astype(np.float32) / 255.0
    return img


def imread(path: str, float32: bool = True, flag: str = "color") -> np.ndarray:
    with open(path, "rb") as f:
        return imfrombytes(f.read(), flag=flag, float32=float32)


def img2array(img: np.ndarray, bgr2rgb: bool = True, float32: bool = True) -> np.ndarray:
    """HWC BGR (cv2) -> HWC RGB float32 [0,1]."""
    if img.ndim == 2:
        img = img[..., None]
    if bgr2rgb and img.shape[2] == 3:
        img = img[..., ::-1]
    img = np.ascontiguousarray(img)
    if float32 and img.dtype != np.float32:
        img = img.astype(np.float32) / 255.0
    return img


def img2tensor(img: np.ndarray) -> torch.Tensor:
    """HWC array -> CHW tensor with the same values (BasicSR's item layout)."""
    return torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))


def array2img(arr, rgb2bgr: bool = True, min_max=(0, 1)) -> np.ndarray:
    """NHWC/HWC float array -> HWC uint8 BGR for imwrite (reference tensor2img)."""
    arr = np.asarray(arr)
    if arr.ndim == 4:
        arr = arr[0]
    arr = np.clip(arr, *min_max)
    arr = (arr - min_max[0]) / (min_max[1] - min_max[0])
    img = (arr * 255.0).round().astype(np.uint8)
    if rgb2bgr and img.ndim == 3 and img.shape[2] == 3:
        img = img[..., ::-1]
    return np.ascontiguousarray(img)


def tensor2img(t: torch.Tensor, rgb2bgr: bool = True) -> np.ndarray:
    """NCHW/CHW float tensor in [0, 1] -> HWC uint8 (``array2img`` of its
    first image, moved to the host)."""
    if t.dim() == 4:
        t = t[0]
    return array2img(t.detach().float().cpu().numpy().transpose(1, 2, 0), rgb2bgr=rgb2bgr)


def imwrite(img: np.ndarray, file_path: str, auto_mkdir: bool = True) -> bool:
    if auto_mkdir:
        os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.imwrite(file_path, img)
    if not file_path.lower().endswith(".png"):
        raise ImportError(_NO_CV2)
    with open(file_path, "wb") as f:
        f.write(png.encode_png(img))
    return True


def crop_border(imgs, crop_border_px: int):
    """Crop `crop_border_px` from each spatial edge (reference img_util.py:166)."""
    if crop_border_px == 0:
        return imgs
    if isinstance(imgs, list):
        return [v[crop_border_px:-crop_border_px, crop_border_px:-crop_border_px, ...] for v in imgs]
    return imgs[crop_border_px:-crop_border_px, crop_border_px:-crop_border_px, ...]
