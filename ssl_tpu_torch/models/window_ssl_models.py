"""ELAN-GAN-SSL and SwinIR-GAN-SSL recipes, and their non-GAN twins
(reference: models/elanganssl_model.py:30-597, swinirganssl_model.py:18-552).

Counterpart of ``ssl_tpu/models/window_ssl_models.py``: the ESRGAN-SSL (or
SR) recipe with a window-attention generator.  The reference's pad to the
windows in ``pre_process`` lives inside the archs' ``forward`` (SwinIR's
always-pad, ELAN's pad to the windows' multiple), so the recipes add
nothing."""

from __future__ import annotations

from ssl_tpu_torch.models.esrganssl_model import ESRGANSSLModel
from ssl_tpu_torch.models.sr_model import SRModel
from ssl_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class ELANGANSSLModel(ESRGANSSLModel):
    """ELAN generator + relativistic GAN + SSL."""


@MODEL_REGISTRY.register()
class SwinIRGANSSLModel(ESRGANSSLModel):
    """SwinIR generator + relativistic GAN + SSL."""


@MODEL_REGISTRY.register()
class SwinIRModel(SRModel):
    """Non-GAN SwinIR recipe (reference swinir_model.py)."""


@MODEL_REGISTRY.register()
class ELANModel(SRModel):
    """Non-GAN ELAN recipe."""
