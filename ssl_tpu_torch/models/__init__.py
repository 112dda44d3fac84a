"""Model builders (reference surface: basicsr/models/__init__.py build_model)."""
from ssl_tpu_torch.models.base_model import BaseModel, TrainState, build_model  # noqa: F401
from ssl_tpu_torch.models.bebyganssl_model import BebyGANModel, BebyGANSSLModel  # noqa: F401
from ssl_tpu_torch.models.bsrganssl_model import (  # noqa: F401
    BSGRANTestModel, BSGRANTestSwinIRModel, BSRGANSSLModel,
)
from ssl_tpu_torch.models.esrganssl_model import ESRGANSSLModel  # noqa: F401
from ssl_tpu_torch.models.ldlssl_model import LDLSSLModel  # noqa: F401
from ssl_tpu_torch.models.ranksrganssl_model import RankSRGANSSLModel  # noqa: F401
from ssl_tpu_torch.models.realesrganssl_model import (  # noqa: F401
    RealESRGANModel, RealESRGANSSLModel, RealESRNetModel, RealESRNetSSLModel,
)
from ssl_tpu_torch.models.spsrssl_model import SPSRSSLModel  # noqa: F401
from ssl_tpu_torch.models.sr_model import SRModel  # noqa: F401
from ssl_tpu_torch.models.srgan_model import ESRGANModel, SRGANModel  # noqa: F401
from ssl_tpu_torch.models.window_ssl_models import (  # noqa: F401
    ELANGANSSLModel, ELANModel, SwinIRGANSSLModel, SwinIRModel,
)
