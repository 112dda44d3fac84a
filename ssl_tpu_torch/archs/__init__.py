"""Network builders (reference surface: basicsr/archs/__init__.py build_network)."""
from ssl_tpu_torch.archs.bsrgan_arch import BSRGANRRDBNet, RRDBBebyGANNet  # noqa: F401
from ssl_tpu_torch.archs.classic_sr_archs import ECBSR, EDSR, RCAN  # noqa: F401
from ssl_tpu_torch.archs.discriminator_arch import (  # noqa: F401
    UNetDiscriminatorSN, VGGStyleDiscriminator,
)
from ssl_tpu_torch.archs.elan_arch import ELAN  # noqa: F401
from ssl_tpu_torch.archs.kair_extra_arch import (  # noqa: F401
    KAIRDiscriminatorPatchGAN, KAIRDiscriminatorVGG96, KAIRDiscriminatorVGG128,
    KAIRDiscriminatorVGG128SN, KAIRDiscriminatorVGG192, KAIRMSRResNet0,
)
from ssl_tpu_torch.archs.ranksrgan_arch import (  # noqa: F401
    Discriminator_VGG_296, RankSRGANSRResNet, Ranker_VGG12_296,
)
from ssl_tpu_torch.archs.rrdbnet_arch import RRDBNet  # noqa: F401
from ssl_tpu_torch.archs.spsr_arch import SPSRNet  # noqa: F401
from ssl_tpu_torch.archs.srresnet_arch import MSRResNet  # noqa: F401
from ssl_tpu_torch.archs.srvgg_arch import SRVGGNetCompact  # noqa: F401
from ssl_tpu_torch.archs.swinir_arch import SwinIR  # noqa: F401
from ssl_tpu_torch.archs.vgg_arch import VGGFeatureExtractor  # noqa: F401
from ssl_tpu_torch.utils.registry import build_network  # noqa: F401
