from ssl_tpu_torch.utils.registry import (  # noqa: F401
    ARCH_REGISTRY, LOSS_REGISTRY, MODEL_REGISTRY, build_loss, build_model, build_network,
)
