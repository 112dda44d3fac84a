"""Process groups and the training mesh on ``torch.distributed``.

Counterpart of ``ssl_tpu/parallel/mesh.py``.  The JAX package puts every
device of a process on one ``Mesh`` and lets XLA insert the collectives; here
one process drives one card, ``torchrun`` starts the processes, and the mesh
is a set of process groups:

* ``init_distributed`` reads torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) and
  starts the default group, NCCL on a card and gloo on the CPU, as the
  ``--device`` of the entry point says;
* ``resolve_mesh`` folds the world into ``data`` x ``fsdp``
  (``parallel: {fsdp: F}``), and ``dp_tp_mesh`` into ``data`` x ``model``
  for the diffusion UNet's tensor parallelism (``parallel: {data, tp}``):
  ranks ``r`` with the same ``r // F`` take the same rows, as the JAX package
  shards the batch over ``data`` only;
* ``global_sum`` is an all-reduce over the ``data`` axis that carries its
  gradient, for the reductions that the JAX step takes over the global batch
  (``models/srgan_model.py``, ``losses/ssl_loss.py``,
  ``archs/discriminator_arch.py::BatchNorm2d``).

No layer reads a current mesh: each model holds its own, passes it to the
reductions over the batch (``ssl_loss``, ``global_mean``), and its
``place_state`` hands it to the D's batch norms.  Without a process group the mesh is one rank
wide and every function here is the identity."""

from __future__ import annotations

import datetime
import functools
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

_TORCHRUN = ("torchrun --nproc_per_node N -m ssl_tpu_torch.train -opt <file> "
             "--launcher pytorch")


@dataclass
class Mesh:
    """The training mesh: ``world`` ranks as ``data`` x ``inner``, the inner
    axis being ``fsdp`` or ``model`` (tensor parallelism); ``rank`` sits at
    (``data_rank``, ``inner_rank``).  ``data_group`` holds the ranks of this
    rank's inner index (the ones that see other rows), ``inner_group`` those
    of its data index (the ones that share its rows); ``device_mesh`` is the
    2-D ``DeviceMesh`` that FSDP shards over (None otherwise)."""
    world: int = 1
    rank: int = 0
    inner: int = 1
    inner_name: str = "fsdp"
    data_group: object = None
    inner_group: object = None
    device_mesh: object = None

    @property
    def data(self) -> int:
        return self.world // self.inner

    @property
    def data_rank(self) -> int:
        return self.rank // self.inner

    @property
    def inner_rank(self) -> int:
        return self.rank % self.inner

    @property
    def fsdp(self) -> int:
        return self.inner if self.inner_name == "fsdp" else 1

    @property
    def tp(self) -> int:
        return self.inner if self.inner_name == "model" else 1

    @property
    def distributed(self) -> bool:
        """Made by ``resolve_mesh`` under a process group (at any width)."""
        return self.data_group is not None


# meshes made under the current default group, by (world, rank, inner, axis):
# ``new_group`` is collective, so a model built again reuses its groups
_MADE: dict = {}


def init_distributed(device, timeout: float | None = None) -> torch.device:
    """Start the default process group from torchrun's environment; returns
    this rank's device (``cuda:{LOCAL_RANK}`` for a CUDA ``device``).  NCCL
    serves CUDA and gloo the CPU; a process group that cannot start raises,
    and a CUDA device never falls back to gloo.  ``timeout`` (seconds) bounds
    every collective; torch's default when None."""
    device = torch.device(device)
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in env]
    if missing and not dist.is_initialized():
        raise RuntimeError(f"--launcher pytorch needs torchrun's environment ({', '.join(missing)} "
                           f"unset): run {_TORCHRUN}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--launcher pytorch on cuda: no CUDA device is available")
        device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
        dist.init_process_group(backend, init_method="env://", **kwargs)
    return device


def get_dist_info() -> tuple[int, int]:
    """(rank, world_size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main() -> bool:
    return get_dist_info()[0] == 0


def master_only(func):
    """Run ``func`` on rank 0 alone (reference dist_util.py:74-82)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if is_main():
            return func(*args, **kwargs)
    return wrapper


def barrier() -> None:
    """Wait for every rank; nothing without a process group."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def check_num_devices(opt: dict, world: int) -> None:
    """``num_devices``: ``auto`` is the world size; a number must equal it."""
    n = opt.get("num_devices", "auto")
    if n not in (None, "auto") and int(n) != world:
        if world == 1:
            raise ValueError(f"num_devices {n}: one process drives one card; run {_TORCHRUN} "
                             f"with N = {n}")
        raise ValueError(f"num_devices {n} does not match the world size {world}")


def resolve_mesh(opt: dict | None) -> Mesh:
    """The training mesh of the option dict.

    ``num_devices`` must be ``auto`` or the world size; ``parallel.fsdp``
    must divide the world size.  Without a process group, or with ``dist``
    false (the CLIs' ``--launcher none``), the mesh is one rank wide,
    whatever ``parallel`` says (the JAX package's one-device mesh)."""
    opt = opt or {}
    rank, world = get_dist_info() if opt.get("dist", True) else (0, 1)
    check_num_devices(opt, world)
    fsdp = int((opt.get("parallel") or {}).get("fsdp", 1) or 1)
    if world % fsdp:
        raise ValueError(f"parallel.fsdp={fsdp} must divide the world size {world}")
    return _make_mesh(rank, world, fsdp, "fsdp") if opt.get("dist", True) else Mesh()


def dp_tp_mesh(parallel: dict | None) -> Mesh:
    """The diffusion tree's (``data``, ``model``) mesh of ``parallel: {data:
    D, tp: T}``: T ranks share each
    ``data`` index and split the UNet's Megatron layers; D defaults to the
    world size over T, and D x T must be the world size."""
    parallel = parallel or {}
    rank, world = get_dist_info()
    tp = int(parallel.get("tp", 1) or 1)
    data = int(parallel.get("data", max(1, world // tp)) or 1)
    if data * tp != world:
        raise ValueError(f"parallel data {data} x tp {tp} must be the world size {world}"
                         + (f": run torchrun --nproc_per_node {data * tp}" if world == 1 else ""))
    return _make_mesh(rank, world, tp, "model")


def _make_mesh(rank: int, world: int, inner: int, inner_name: str) -> Mesh:
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(inner_name=inner_name)
    key, default = (world, rank, inner, inner_name), dist.group.WORLD
    made = _MADE.get(key)
    if made is not None and made[0] is default:
        return made[1]
    # every rank creates every group, in the same order
    data_group = inner_group = None
    for f in range(inner):
        group = dist.new_group(list(range(f, world, inner)))
        if rank % inner == f:
            data_group = group
    for d in range(world // inner):
        group = dist.new_group(list(range(d * inner, (d + 1) * inner)))
        if rank // inner == d:
            inner_group = group
    device_mesh = None
    if inner > 1 and inner_name == "fsdp":
        from torch.distributed.device_mesh import init_device_mesh
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        device_mesh = init_device_mesh(device_type, (world // inner, inner),
                                       mesh_dim_names=("data", "fsdp"))
    mesh = Mesh(world=world, rank=rank, inner=inner, inner_name=inner_name,
                data_group=data_group, inner_group=inner_group, device_mesh=device_mesh)
    _MADE[key] = (default, mesh)
    return mesh


def data_axis_size(mesh: Mesh | None) -> int:
    return 1 if mesh is None else mesh.data


def shard_batch(batch: dict, mesh: Mesh | None) -> dict:
    """This rank's rows of a global batch: the ``data_rank``-th of ``data``
    equal slices of every tensor's leading dim; other leaves pass through
    (every row with no mesh)."""
    if mesh is None or mesh.data == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if torch.is_tensor(v) and v.dim() >= 1:
            if v.shape[0] % mesh.data:
                raise ValueError(f"batch {k}: {v.shape[0]} rows do not split over "
                                 f"{mesh.data} data ranks")
            n = v.shape[0] // mesh.data
            v = v[mesh.data_rank * n:(mesh.data_rank + 1) * n]
        out[k] = v
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the gradient of each input is the sum of the
    output's gradients over the group (every rank's loss may depend on every
    rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def global_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``x`` summed over ``mesh``'s ``data`` axis, with its gradient (through
    the all-reduce even on a one-rank axis); ``x`` itself without a
    distributed mesh."""
    if mesh is None or mesh.data_group is None:
        return x
    return _AllReduceSum.apply(x, mesh.data_group)


def global_mean(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The mean of every element of ``x`` over the global batch of ``mesh``
    (equal rows on every rank), with its gradient; ``torch.mean(x)`` without
    a distributed mesh."""
    if mesh is None or mesh.data_group is None:
        return torch.mean(x)
    return global_sum(torch.sum(x), mesh) / float(x.numel() * mesh.data)


def mean_over_ranks(values: dict) -> dict:
    """The mean over every rank of a dict of 0-dim tensors (the logged
    losses), in one all-reduce; the dict itself in a one-rank world."""
    rank, world = get_dist_info()
    if world == 1 or not values:
        return values
    keys = list(values)
    flat = torch.stack([torch.as_tensor(values[k], dtype=torch.float64).reshape(())
                        .to(_comm_device()) for k in keys])
    dist.all_reduce(flat)
    flat = flat / world
    return {k: flat[i] for i, k in enumerate(keys)}


def _comm_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
