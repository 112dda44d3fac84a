from ssl_tpu_torch.ops.ssg import (  # noqa: F401
    SSGConfig,
    apply_mask_stride,
    reflect_pad_2d,
    ssl_loss_dense_bwd,
    ssl_loss_sums_reference,
)
