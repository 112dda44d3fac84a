"""The port's host C++ (``pipeline.cpp``): the JPEG round trip and the
reflect-101 ``filter2d`` of the two-stage degrader, and the libjpeg-exact
JPEG round trip of the BSRGAN degradation, bound with ``ctypes``.

Counterpart of ``ssl_tpu/native`` (its ``box_ssd_ssg`` oracle stays there).
The library is compiled by ``g++`` at first use into
``ssl_tpu_torch/_build/``, named by a hash of the source and the flags, so an
edited source is rebuilt; nothing is built next to the sources and nothing
runs at import time.  A failed build raises: there is no quiet numpy
fall-back (the numpy versions in ``data/realesr_degradation.py`` are the
plain versions the tests hold this against)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ssl_tpu_torch.ops.cuda_build import BUILD_DIR, PACKAGE_DIR

SOURCE = PACKAGE_DIR / "native" / "pipeline.cpp"
# portable code (no -march=native): the build directory may be copied to
# another machine with the checkout
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()


def library_path():
    """Where the library goes: named by a hash of the source and the flags."""
    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libpipeline-{digest.hexdigest()[:12]}.so"


def build():
    """Compile ``pipeline.cpp`` unless its library exists; returns its path.
    Raises ``RuntimeError`` with the compiler's output if ``g++`` fails or is
    missing."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        run = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"g++ could not be run to build {SOURCE.name}: {e}") from e
    if run.returncode != 0:
        raise RuntimeError(f"g++ failed building {SOURCE.name}:\n{run.stdout}{run.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            cint = ctypes.c_int
            lib.jpeg_roundtrip_batch.argtypes = [f32p, cint, cint, cint, f32p, cint]
            lib.jpeg_roundtrip_batch.restype = None
            lib.filter2d_reflect_batch.argtypes = [f32p, f32p, cint, cint, cint, cint, f32p,
                                                   cint, cint]
            lib.filter2d_reflect_batch.restype = None
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.jpeg_libjpeg_roundtrip.argtypes = [u8p, cint, cint, cint]
            lib.jpeg_libjpeg_roundtrip.restype = None
            _LIB = lib
    return _LIB


def jpeg_roundtrip_batch(imgs: np.ndarray, qualities, n_threads: int = 8) -> np.ndarray:
    """(b, h, w, 3) RGB float32 in [0, 1], one quality per image -> the JPEG
    round trip of each, at its size (padded with 0 to a multiple of 16
    inside, as the reference DiffJPEG pads)."""
    if imgs.ndim != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"expected (b, h, w, 3) images, got {imgs.shape}")
    b, h, w = imgs.shape[:3]
    q = np.ascontiguousarray(np.asarray(qualities, np.float32).reshape(-1))
    if q.shape[0] != b:
        raise ValueError(f"{q.shape[0]} qualities for {b} images")
    ph, pw = (16 - h % 16) % 16, (16 - w % 16) % 16
    buf = np.ascontiguousarray(np.pad(imgs, ((0, 0), (0, ph), (0, pw), (0, 0))), np.float32)
    library().jpeg_roundtrip_batch(buf, b, h + ph, w + pw, q, n_threads)
    return buf[:, :h, :w]


def filter2d_batch(imgs: np.ndarray, kernels: np.ndarray, n_threads: int = 8) -> np.ndarray:
    """(b, h, w, c) float32 images, each correlated with its own (k, k)
    kernel (``kernels`` (b, k, k), k odd) over a reflect-101 border."""
    if imgs.ndim != 4:
        raise ValueError(f"expected (b, h, w, c) images, got {imgs.shape}")
    b, h, w, c = imgs.shape
    kernels = np.ascontiguousarray(kernels, np.float32)
    if kernels.ndim != 3 or kernels.shape[0] != b or kernels.shape[1] != kernels.shape[2] \
            or kernels.shape[1] % 2 == 0:
        raise ValueError(f"expected {b} odd square kernels, got {kernels.shape}")
    src = np.ascontiguousarray(imgs, np.float32)
    out = np.empty_like(src)
    library().filter2d_reflect_batch(src, out, b, h, w, c, kernels, kernels.shape[1], n_threads)
    return out


def jpeg_libjpeg_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    """(h, w, 3) RGB uint8 -> its baseline JPEG encode and decode at
    ``quality`` as libjpeg computes them at ``cv2``'s defaults (4:2:0, the
    integer DCTs, fancy upsampling): ``cv2.imdecode(cv2.imencode(".jpg",
    img, [cv2.IMWRITE_JPEG_QUALITY, quality]))`` in RGB."""
    if img.ndim != 3 or img.shape[-1] != 3 or img.dtype != np.uint8:
        raise ValueError(f"expected an (h, w, 3) uint8 image, got {img.dtype} {img.shape}")
    out = np.ascontiguousarray(img).copy()
    library().jpeg_libjpeg_roundtrip(out, out.shape[0], out.shape[1], int(quality))
    return out
