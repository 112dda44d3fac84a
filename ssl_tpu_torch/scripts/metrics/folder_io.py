"""The GT / restored pairing of the metric CLIs.  They read images with
``utils/img_util.py::imread(path, float32=False)``: HWC BGR uint8, None where
cv2 cannot decode the file (without cv2 only PNG decodes; another format
raises ``ImportError``)."""

from __future__ import annotations

import os


def restored_path(restored_dir: str, name: str, suffix: str) -> str | None:
    """``<base><suffix><ext>`` in ``restored_dir``, else the first file
    (sorted) whose name starts with ``<base>``, else None."""
    base, ext = os.path.splitext(name)
    path = os.path.join(restored_dir, base + suffix + ext)
    if os.path.exists(path):
        return path
    cands = [p for p in sorted(os.listdir(restored_dir)) if p.startswith(base)]
    return os.path.join(restored_dir, cands[0]) if cands else None
