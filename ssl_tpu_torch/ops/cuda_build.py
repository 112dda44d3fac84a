"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``ssl_tpu_torch/csrc/<name>.cu`` with a plain C entry
point.  At first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared
library under ``ssl_tpu_torch/_build/`` (named by a hash of its source and
flags, so an edited source is rebuilt) and loaded with ``ctypes``.  Nothing
here runs at import time: a CPU-only machine imports the package without a
CUDA toolkit."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else
    ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
                       "compiled from ssl_tpu_torch/csrc at first use")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path and the compiler's output (empty if nothing was built).
    Raises ``RuntimeError`` with that output if nvcc fails."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    run = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
                         capture_output=True, text=True, timeout=600)
    log = run.stdout + run.stderr
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name}:\n{log}")
    os.replace(tmp, out)
    return out, log


def load_library(name: str, declare) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``declare(lib)`` sets the
    ctypes signatures once.  Cached per process."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[0]))
        declare(lib)
        _LIBS[name] = lib
    return lib
