from ssl_tpu_torch.ops.ssg import (  # noqa: F401
    SSGConfig,
    apply_mask_stride,
    mask_to_positions,
    reflect_pad_2d,
    ssg_epilogue,
    ssg_from_mask,
    ssg_matrix,
    ssg_ssd_maps_scan,
    ssl_loss_dense_bwd,
    ssl_loss_sums_reference,
)
