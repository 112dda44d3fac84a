"""Folder CLIs of the metric suite, without JAX: ``python -m
ssl_tpu_torch.scripts.metrics.<name>`` for each of ``scripts/metrics/*.py``,
with its flags (and ``--device`` for the deep metrics) and its output lines.
Images are read with ``cv2`` where it imports, else PNG through
``utils/png.py``."""
