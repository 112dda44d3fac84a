"""Loss builders (reference surface: basicsr/losses/__init__.py build_loss)."""
from ssl_tpu_torch.losses.basic_loss import (  # noqa: F401
    BCELoss, CharbonnierLoss, CosineDistanceLoss, CrossEntropyLoss, KLDistanceLoss,
    KLDistanceLoss1, L1Loss, MaxDistanceLoss, MSELoss, SmoothL2Loss, SSIMLoss, WeightedTVLoss,
)
from ssl_tpu_torch.losses.gan_loss import GANFeatLoss, GANLoss, MultiScaleGANLoss  # noqa: F401
from ssl_tpu_torch.losses.feature_sim import PerceptualSimLoss  # noqa: F401
from ssl_tpu_torch.losses.perceptual import PerceptualLoss  # noqa: F401
from ssl_tpu_torch.losses.ssl_loss import SSLSetting, ssl_loss, ssl_setting_from_opt  # noqa: F401
from ssl_tpu_torch.utils.registry import build_loss  # noqa: F401
