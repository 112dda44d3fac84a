"""The trained nets on the mesh: DDP over ``data``, FSDP over (``data``, ``fsdp``).

Counterpart of ``ssl_tpu/parallel/fsdp.py``, where the stacked-block leaves
of the scanned trunks shard over ``fsdp`` and XLA gathers them on demand.
Here:

* at ``fsdp`` 1 every trained net goes into ``DistributedDataParallel``
  (buffers are not broadcast: the synced batch norm keeps them equal);
* at ``fsdp`` F > 1 each block of the generator's trunk (``net.body``, the
  RRDBs of RRDBNet) that holds at least ``parallel.fsdp_min_size`` values is
  ``fully_shard``-ed over the 2-D ``DeviceMesh`` (HSDP: sharded over ``fsdp``,
  replicated over ``data``).  The rest of the generator stays replicated, its
  gradients averaged over the world in ``sync_replicated_grads``; the
  discriminator stays in DDP.  Ranks of one ``fsdp`` group take the same
  rows, so every gradient is the mean over the world, as at ``fsdp`` 1;
* checkpoints are gathered full tensors (``full_state_dict``,
  ``full_optimizer_state_dict``), with no ``module.`` prefix: the files of a
  sharded run are those of a one-rank run.  A run loads them into its plain
  nets before ``BaseModel.place_state`` wraps and shards them
  (``reshard_optimizer`` lays the optimizer's moments out like the shards)."""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist
from torch import nn

from ssl_tpu_torch.parallel.mesh import Mesh

_WORLD_MEAN = "_ssl_world_mean"       # marks a replicated parameter of a sharded net


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def unwrap(net: nn.Module | None) -> nn.Module | None:
    """The module inside a DDP wrapper (a sharded net is its own module)."""
    return net.module if isinstance(net, nn.parallel.DistributedDataParallel) else net


def data_parallel(net: nn.Module) -> nn.Module:
    """``net`` in DDP over the default group."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)     # broadcast_buffers' rename
        return nn.parallel.DistributedDataParallel(net, broadcast_buffers=False)


def shard_blocks(net: nn.Module, mesh: Mesh, min_size: int = 2 ** 14) -> None:
    """``fully_shard`` each block of ``net.body`` with at least ``min_size``
    values over ``mesh.device_mesh``; mark every other parameter for
    ``sync_replicated_grads``."""
    from torch.distributed.fsdp import fully_shard
    body = getattr(net, "body", None)
    for block in (body if isinstance(body, (nn.Sequential, nn.ModuleList)) else ()):
        if sum(p.numel() for p in block.parameters()) >= min_size:
            fully_shard(block, mesh=mesh.device_mesh, reshard_after_forward=True)
    for p in net.parameters():
        if not _is_dtensor(p):
            setattr(p, _WORLD_MEAN, True)


def sync_replicated_grads(params) -> None:
    """Average over the world the gradients of the parameters that
    ``shard_blocks`` left replicated, in one all-reduce."""
    grads = [p.grad for p in params if getattr(p, _WORLD_MEAN, False) and p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    for g, src in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(src.view_as(g))


def full_params(net: nn.Module) -> list[torch.Tensor]:
    """The net's parameters as full tensors (sharded ones gathered)."""
    return [p.full_tensor() if _is_dtensor(p) else p for p in unwrap(net).parameters()]


def full_state_dict(net: nn.Module) -> dict:
    """The state dict of ``net`` on the host, unwrapped and gathered: the keys
    and values of the same net at one rank.  Every rank must call it."""
    out = {}
    for k, v in unwrap(net).state_dict().items():
        if _is_dtensor(v):
            v = v.full_tensor()
        out[k] = v.detach().cpu()
    return out


def _to_placement(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full.to(like.device, like.dtype), like.device_mesh, like.placements)


def full_optimizer_state_dict(opt: torch.optim.Optimizer) -> dict:
    """``opt.state_dict()`` with every sharded moment gathered to the host."""
    sd = opt.state_dict()
    sd["state"] = {i: {k: (v.full_tensor().cpu() if _is_dtensor(v) else v)
                       for k, v in s.items()} for i, s in sd["state"].items()}
    return sd


def reshard_optimizer(opt: torch.optim.Optimizer, params: list) -> torch.optim.Optimizer:
    """A new optimizer of ``opt``'s class and settings over ``params`` (the
    same parameters after ``fully_shard`` replaced them), with ``opt``'s
    state laid out like each new parameter.  Its update runs parameter by
    parameter (``foreach`` off): one foreach call may not mix the sharded
    parameters with the replicated ones."""
    old = [p for g in opt.param_groups for p in g["params"]]
    if len(opt.param_groups) != 1 or len(old) != len(params):
        raise NotImplementedError("parallel.fsdp: the optimizer must hold the sharded net's "
                                  "parameters in one group")
    sd = full_optimizer_state_dict(opt)
    settings = dict(opt.defaults)
    for group in (settings, *sd["param_groups"]):
        if "foreach" in group:
            group["foreach"] = False
    new = type(opt)(params, **settings)
    sd["state"] = {i: {k: (_to_placement(v, params[i])
                           if torch.is_tensor(v) and v.shape == params[i].shape else v)
                       for k, v in s.items()} for i, s in sd["state"].items()}
    new.load_state_dict(sd)
    return new
