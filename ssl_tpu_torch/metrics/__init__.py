"""Metric dispatcher (reference surface: metrics/__init__.py calculate_metric).

Counterpart of ``ssl_tpu/metrics/__init__.py``: PSNR and SSIM, NIQE,
LPIPS, DISTS, FID and CLIP-IQA (MUSIQ where ``pyiqa`` imports), each
registered by its module.  The deep metrics take the model's ``device``."""
from copy import deepcopy

from ssl_tpu_torch.metrics import clipiqa, dists_metric, fid, lpips_metric, niqe  # noqa: F401
from ssl_tpu_torch.metrics.psnr_ssim import calculate_psnr, calculate_ssim  # noqa: F401
from ssl_tpu_torch.utils.registry import METRIC_REGISTRY


def calculate_metric(data: dict, opt: dict):
    """Dispatch on opt['type'], passing the rest as kwargs."""
    opt = deepcopy(opt)
    metric_type = opt.pop("type")
    opt.pop("better", None)
    return METRIC_REGISTRY.get(metric_type)(**data, **opt)
