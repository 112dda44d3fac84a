"""BSRGAN-SSL, the KAIR-tree recipe (reference:
train_BSGRAN/models/model_ssl.py:33-550), and the KAIR test models.

Counterpart of ``ssl_tpu/models/bsrganssl_model.py``: the ESRGAN-SSL step
(K1 in its SSL loss) with the KAIR options' ``lsgan`` GAN type, ``E_decay``
EMA and ``train.mask_stride`` applied (model_ssl.py:293-294; the GAN-tree
recipes leave it off).  Its data come from ``DatasetBlindSRMask`` and the
BSRGAN degradation."""

from __future__ import annotations

from ssl_tpu_torch.models.esrganssl_model import ESRGANSSLModel
from ssl_tpu_torch.models.sr_model import SRModel
from ssl_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class BSRGANSSLModel(ESRGANSSLModel):
    """KAIR ModelSSL: gan_opt.gan_type 'lsgan' reproduces the shipped
    BSRGANSSL configs (train_BSRGANSSL_DF2K_OST_x4.json)."""


@MODEL_REGISTRY.register()
class BSGRANTestModel(SRModel):
    """Inference-only evaluation of KAIR-trained checkpoints (reference
    bsrgantest_model.py:21); the shipped test YAMLs name it so."""

    def __init__(self, opt: dict, device=None):
        super().__init__(dict(opt, is_train=False), device=device)


@MODEL_REGISTRY.register()
class BSGRANTestSwinIRModel(BSGRANTestModel):
    """The SwinIR flavour of the KAIR test model (reference
    bsrgantest_swinir_model.py:22)."""
