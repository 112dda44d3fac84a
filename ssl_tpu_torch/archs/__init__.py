"""Network builders (reference surface: basicsr/archs/__init__.py build_network)."""
from ssl_tpu_torch.archs.discriminator_arch import (  # noqa: F401
    UNetDiscriminatorSN, VGGStyleDiscriminator,
)
from ssl_tpu_torch.archs.rrdbnet_arch import RRDBNet  # noqa: F401
from ssl_tpu_torch.archs.vgg_arch import VGGFeatureExtractor  # noqa: F401
from ssl_tpu_torch.utils.registry import build_network  # noqa: F401
