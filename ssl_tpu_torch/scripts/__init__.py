"""Command-line tools of the port (``python -m ssl_tpu_torch.scripts.<name>``)."""
