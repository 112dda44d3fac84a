"""Loss builders (reference surface: basicsr/losses/__init__.py build_loss)."""
from ssl_tpu_torch.losses.basic_loss import KLDistanceLoss, L1Loss  # noqa: F401
from ssl_tpu_torch.losses.gan_loss import GANLoss  # noqa: F401
from ssl_tpu_torch.losses.perceptual import PerceptualLoss  # noqa: F401
from ssl_tpu_torch.losses.ssl_loss import SSLSetting, ssl_loss, ssl_setting_from_opt  # noqa: F401
from ssl_tpu_torch.utils.registry import build_loss  # noqa: F401
