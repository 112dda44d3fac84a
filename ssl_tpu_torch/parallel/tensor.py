"""Tensor parallelism (Megatron column / row layers) for the diffusion UNet
and its struct-cond encoder, with ZeRO-1 sharding of AdamW's moments.

Counterpart of ``ssl_tpu/parallel/tensor.py``, whose rules annotate flax
weights by path name and let GSPMD insert the collectives.  The rules here
are the same pure function (``tp_spec``) on the same names: each port
parameter's flax path comes from ``utils/weight_port.py::unet_flax_path``,
so the same modules go column- and row-parallel as in JAX:

* column-parallel (the output features split over the ``model`` axis): the
  ResBlock's ``in_layers.2`` conv and its ``emb_layers.1`` Linear, SPADE's
  ``mlp_shared.0``, the attention's ``to_q`` / ``to_k`` / ``to_v`` and the
  struct encoder's packed ``qkv`` (whole heads when ``tp`` divides the
  heads); their input is replicated and its gradient summed over the axis;
* row-parallel (the input features split): ``out_layers.3``, SPADE's
  ``mlp_gamma`` / ``mlp_beta``, the attention's ``to_out.0`` and the struct
  encoder's ``proj_out``; their partial outputs are summed over the axis
  before the (replicated) bias;
* the GroupNorm ``out_layers.0`` between them normalises the channel-split
  stream: its 32 groups are contiguous channel blocks, 32 / tp per rank;
* every other parameter (skips, resampling convs, GEGLU, the norms, the
  time embedding, the frozen VAE) stays whole.

Each attention then sees ``heads / tp`` heads, and K2's wrappers plan their
launches from the per-rank head count of the tensors they get
(``ops/attention_cuda.py::fwd_plan``, ``bwd_plan``).

``zero: true`` (``state_plan``) adds ZeRO-1: for each parameter the rules
left whole that holds at least ``zero_min_size`` values, AdamW's moments are
split over the ``model`` axis on the parameter's largest divisible dim; each
rank updates its slice and the slices are gathered into the parameter.  The
EMA stays whole (the JAX package shards it too; values are the same)."""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ssl_tpu_torch.utils.weight_port import unet_flax_path

# flax module names whose kernel shards on the OUT feature dim (last axis)
_COL_MODULES = ("in_layers_2", "emb_layers_1", "spade_mlp_shared_0", "qkv")
_COL_SUFFIXES = ("_to_q", "_to_k", "_to_v")
# flax module names whose kernel shards on the IN feature dim
_ROW_MODULES = ("out_layers_3", "spade_mlp_gamma", "spade_mlp_beta")
_ROW_SUFFIXES = ("_to_out_0",)
NETS = ("unet", "structcond")


def tp_spec(names: list[str], shape, tp: int) -> int | None:
    """The dim of a flax-layout leaf that splits over the ``model`` axis, or
    None (whole): the JAX package's ``tp_spec`` rules, which return the same
    as a ``PartitionSpec``."""
    if not shape or ("unet" not in names and "structcond" not in names):
        return None
    name = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    is_col = parent in _COL_MODULES or parent.endswith(_COL_SUFFIXES)
    is_row = (parent in _ROW_MODULES or parent.endswith(_ROW_SUFFIXES)
              or (parent == "proj_out" and "structcond" in names))
    if name == "kernel":
        if is_col and shape[-1] % tp == 0:
            return len(shape) - 1
        if is_row and len(shape) >= 2 and shape[-2] % tp == 0:
            return len(shape) - 2
    elif name in ("bias", "scale"):
        if (is_col or parent == "out_layers_0") and shape[0] % tp == 0:
            return 0
    return None


def zero_dim(shape, tp: int) -> int | None:
    """ZeRO's dim of a whole leaf (flax layout): its largest dim that ``tp``
    divides, the first of equals; None where none does."""
    dims = [d for d in range(len(shape)) if shape[d] % tp == 0]
    return max(dims, key=lambda d: shape[d]) if dims else None


def flax_shape(shape) -> tuple:
    """A torch weight's shape in flax's layout: OIHW -> HWIO, (O, I, 1) and
    (O, I) -> (I, O)."""
    shape = tuple(shape)
    if len(shape) == 4:
        return shape[2], shape[3], shape[1], shape[0]
    if len(shape) in (2, 3):
        return shape[1], shape[0]
    return shape


def torch_dim(flax_dim: int, ndim: int) -> int:
    """The torch dim of a flax-layout dim of an ``ndim``-d torch weight."""
    if ndim == 4:
        return {3: 0, 2: 1, 0: 2, 1: 3}[flax_dim]
    if ndim in (2, 3):
        return 1 - flax_dim
    return flax_dim


def state_plan(params: dict, tp: int, zero: bool = False,
               zero_min_size: int = 2 ** 14) -> dict:
    """The split of every trained leaf, by its key (``unet.<name>``,
    ``structcond.<name>``, ``null_context``): ``{"params": {key: dim},
    "moments": {key: dim}}`` with torch dims, None for a whole leaf.  The
    parameters (and the EMA) follow ``tp_spec``; AdamW's moments follow it
    too, and with ``zero`` split a whole leaf of at least ``zero_min_size``
    values on ``zero_dim`` (the JAX ``state_tp_shardings``)."""
    out = {"params": {}, "moments": {}}
    leaves = [(f"{net}.{k}", [net, *unet_flax_path(k, p.dim())], p.shape)
              for net in NETS for k, p in params[net].named_parameters()]
    leaves.append(("null_context", ["null_context"], params["null_context"].shape))
    for key, names, shape in leaves:
        # the null context is a bare array, in the same layout in both packages
        to_torch = (lambda d: d) if key == "null_context" else \
            (lambda d, n=len(shape): torch_dim(d, n))
        fshape = tuple(shape) if key == "null_context" else flax_shape(shape)
        dim = tp_spec(names, fshape, tp)
        out["params"][key] = None if dim is None else to_torch(dim)
        mdim = dim
        if zero and dim is None and int(torch.Size(shape).numel()) >= zero_min_size:
            mdim = zero_dim(fshape, tp)
        out["moments"][key] = None if mdim is None else to_torch(mdim)
    return out


def trained_keys(params: dict) -> list[str]:
    """The keys of ``state_plan`` in ``diffusion/ddpm_ssl.py::trainable``'s order."""
    return ([f"{net}.{k}" for net in NETS for k, _ in params[net].named_parameters()]
            + ["null_context"])


# ----------------------------------------------------------- the collectives

class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the ``model`` axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    """Partial outputs summed over the ``model`` axis; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x, group):
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x, group):
    return x if group is None else _ReduceFromTP.apply(x, group)


class _ColumnParallel:
    """Mixed into a Linear / Conv2d whose output features are split."""

    def forward(self, x):
        return super().forward(copy_to_tp(x, self.tp_group))


class _RowParallel:
    """Mixed into a Linear / Conv2d whose input features are split: the
    partial products are summed, then the whole bias is added."""

    def forward(self, x):
        w = self.weight.to(x.dtype)
        y = F.linear(x, w) if isinstance(self, nn.Linear) else self._conv_forward(x, w, None)
        y = reduce_from_tp(y, self.tp_group)
        if self.bias is None:
            return y
        b = self.bias.to(y.dtype)
        return y + (b if isinstance(self, nn.Linear) else b[None, :, None, None])


_CLASSES: dict = {}


def _as(module: nn.Module, mixin, group) -> None:
    key = (type(module), mixin)
    if key not in _CLASSES:
        _CLASSES[key] = type(f"{mixin.__name__[1:]}{type(module).__name__}",
                             (mixin, type(module)), {})
    module.__class__ = _CLASSES[key]
    module.tp_group = group


def _local(t: torch.Tensor, dim: int, tp: int, rank: int) -> torch.Tensor:
    n = t.shape[dim] // tp
    return t.detach().narrow(dim, rank * n, n).clone()


@torch.no_grad()
def apply_tp(net: nn.Module, plan: dict, prefix: str, tp: int, rank: int, group) -> None:
    """Split ``net`` (``params[prefix]``) over the ``model`` axis in place by
    ``plan["params"]``: each split parameter is replaced by this rank's
    slice, each split layer computes as its column / row part, and each
    attention takes its ``heads / tp`` heads."""
    from ssl_tpu_torch.diffusion.unet import AttentionBlockQKV, CrossAttention, GroupNorm
    if tp == 1:
        return
    dims = {k[len(prefix) + 1:]: d for k, d in plan["params"].items()
            if k.startswith(prefix + ".") and d is not None}
    for name, module in net.named_modules():
        w = dims.get(f"{name}.weight")
        if isinstance(module, AttentionBlockQKV):
            if module.num_heads % tp:
                raise ValueError(f"tp {tp} must divide the {module.num_heads} heads of {name}")
            module.tp, module.tp_group = tp, group
        elif isinstance(module, CrossAttention):
            if module.heads % tp:
                raise ValueError(f"tp {tp} must divide the {module.heads} heads of {name}")
        if w is None:
            continue
        if isinstance(module, GroupNorm):
            if module.num_groups % tp:
                raise ValueError(f"tp {tp} must divide the {module.num_groups} groups of {name}")
            module.num_groups //= tp
            module.num_channels //= tp
        elif isinstance(module, nn.Conv1d):
            pass            # AttentionBlockQKV's qkv / proj_out: split in its forward
        else:
            _as(module, _ColumnParallel if w == 0 else _RowParallel, group)
        for leaf in ("weight", "bias"):
            d = dims.get(f"{name}.{leaf}")
            if d is not None:
                p = getattr(module, leaf)
                setattr(module, leaf, nn.Parameter(_local(p, d, tp, rank),
                                                   requires_grad=p.requires_grad))
    for module in net.modules():
        if isinstance(module, CrossAttention):
            module.heads //= tp


@torch.no_grad()
def gather_tp(t: torch.Tensor, dim: int | None, tp: int, group) -> torch.Tensor:
    """The whole tensor of this rank's slice ``t`` on ``dim`` (``t`` where
    ``dim`` is None or ``tp`` is 1)."""
    if dim is None or tp == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(tp)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def full_net_state(net: nn.Module, plan: dict, prefix: str, tp: int, group) -> dict:
    """``net``'s state dict with every split parameter gathered whole."""
    return {k: gather_tp(v, plan["params"].get(f"{prefix}.{k}"), tp, group)
            for k, v in net.state_dict().items()}


class ZeroAdamW:
    """AdamW over the ranks' parameters where each moment lies as
    ``state_plan``'s ``moments`` say: a parameter split by the rules updates
    its own slice; a whole parameter with a ZeRO dim updates this rank's
    slice of it, whose moments alone it keeps, and the slices are gathered
    into the parameter; any other whole parameter updates whole.  One
    ``torch.optim.AdamW`` runs over those slices, in ``trainable``'s order,
    so its state is indexed as the one-rank optimizer's."""

    def __init__(self, params: list, keys: list, plan: dict, tp: int, rank: int, group,
                 **adamw):
        self.params, self.tp, self.rank, self.group = params, tp, rank, group
        self.zero = [None if plan["params"][k] is not None else plan["moments"][k]
                     for k in keys]
        self.slots = [p if d is None else nn.Parameter(_local(p, d, tp, rank))
                      for p, d in zip(params, self.zero)]
        self.opt = torch.optim.AdamW(self.slots, **adamw)

    @property
    def param_groups(self):
        return self.opt.param_groups

    def state_dict(self):
        return self.opt.state_dict()

    def load_state_dict(self, sd):
        self.opt.load_state_dict(sd)

    def zero_grad(self, set_to_none: bool = True):
        for p in self.params:
            if p.grad is not None:
                if set_to_none:
                    p.grad = None
                else:
                    p.grad.zero_()

    @torch.no_grad()
    def step(self):
        for p, s, d in zip(self.params, self.slots, self.zero):
            if d is not None:
                s.grad = None if p.grad is None else _local(p.grad, d, self.tp, self.rank)
        self.opt.step()
        for p, s, d in zip(self.params, self.slots, self.zero):
            if d is not None:
                p.copy_(gather_tp(s.detach(), d, self.tp, self.group))
