"""Dataset builders (reference surface: basicsr/data/__init__.py).

Counterpart of ``ssl_tpu/data/__init__.py`` for the paired datasets of the
ESRGAN-SSL recipe and the GT + kernel datasets of RealESRGAN-SSL; the
blind-SR, video and CFW datasets are later slices (ROADMAP.md)."""
from copy import deepcopy

from ssl_tpu_torch.data import paired_image_dataset as _p  # noqa: F401
from ssl_tpu_torch.data import realesrgan_dataset as _r  # noqa: F401
from ssl_tpu_torch.data.loader import EnlargedSampler, build_dataloader, device_prefetch  # noqa: F401
from ssl_tpu_torch.data.paired_image_dataset import (  # noqa: F401
    MultiLROneGTDataset, MyPairedImageDataset, PairedImageDataset, PairedImageMaskDataset,
    SingleImageDataset, load_mask,
)
from ssl_tpu_torch.data.realesrgan_dataset import (  # noqa: F401
    MyRealESRGANImageMaskDataset, RealESRGANDataset,
)
from ssl_tpu_torch.utils.registry import DATASET_REGISTRY


def build_dataset(dataset_opt: dict):
    dataset_opt = deepcopy(dataset_opt)
    return DATASET_REGISTRY.get(dataset_opt["type"])(dataset_opt)
