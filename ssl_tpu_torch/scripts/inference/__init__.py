"""Torch entry points of ``inference/*.py``: ``python -m
ssl_tpu_torch.scripts.inference.<name>``."""
