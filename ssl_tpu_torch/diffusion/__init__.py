"""The StableSR-SSL diffusion tree: the train step (``StableSRSSL.train_step``)
and serving (encode, spaced DDPM / DDIM / PLMS over the struct-cond encoder
and the dual-cond UNet, decode, color fix), the training CLI (``main``),
StableSR's stage 2 (the CFW autoencoder, ``cfw_train``) and the
reference-schema configs (``ref_config``).  Counterpart of ``ssl_tpu/diffusion``."""
from ssl_tpu_torch.diffusion.color_fix import adain_color_fix, wavelet_color_fix  # noqa: F401
from ssl_tpu_torch.diffusion.ddpm_ssl import (  # noqa: F401
    DiffusionSSLConfig, DiffusionState, StableSRSSL,
)
from ssl_tpu_torch.diffusion.sampler import ddim_sample, spaced_ddpm_sample, tiled_sample  # noqa: F401
from ssl_tpu_torch.diffusion.schedules import (  # noqa: F401
    build_schedule_arrays, make_beta_schedule, q_sample, space_timesteps,
)
from ssl_tpu_torch.diffusion.unet import EncoderUNetModelWT, UNetModelDualcondV2  # noqa: F401
from ssl_tpu_torch.diffusion.vae import AutoencoderKL, AutoencoderKLResi  # noqa: F401
