"""Multi-card runs on ``torch.distributed`` (counterpart of ``ssl_tpu/parallel``):
the mesh and its process groups (``mesh``), DDP and FSDP of the trained nets
(``fsdp``), height-sharded SR inference (``spatial``) and the UNet's tensor
parallelism (``tensor``)."""
from ssl_tpu_torch.parallel.mesh import (  # noqa: F401
    get_dist_info, init_distributed, master_only, resolve_mesh, shard_batch,
)
