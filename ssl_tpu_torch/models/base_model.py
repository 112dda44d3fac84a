"""BaseModel: the training state and the pieces every recipe shares.

Counterpart of ``ssl_tpu/models/base_model.py``.  The JAX package keeps the
whole state as one immutable pytree; here the state holds ``nn.Module``s and
``torch.optim`` optimizers, and ``train_step(state, batch)`` updates it in
place (returning it, so the call reads like the JAX one).  Field mapping:

    JAX TrainState            TrainState here
    step                      step (Python int)
    params_g, opt_state_g     net_g, opt_g
    ema_params_g              net_g_ema
    params_d, stats_d         net_d (its batch-norm buffers are the stats)
    opt_state_d               opt_d

The JAX ``rng`` has no counterpart: nothing on this recipe's path draws
random numbers during a step."""

from __future__ import annotations

from copy import deepcopy
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from ssl_tpu_torch.utils.registry import build_model, build_network  # noqa: F401


@dataclass
class TrainState:
    step: int
    net_g: nn.Module
    opt_g: torch.optim.Optimizer
    net_g_ema: nn.Module | None = None
    net_d: nn.Module | None = None
    opt_d: torch.optim.Optimizer | None = None


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device.  There is no silent
    CPU run: without a CUDA device the default fails."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the port runs on cuda unless "
                           "the caller passes device='cpu'")
    return dev


def build_optimizer(optim_opt: dict, params, schedule: Callable):
    """Optimizer factory (reference base_model.py:103-120).  Only Adam is
    ported; its learning rate is written from ``schedule`` at every step."""
    o = deepcopy(optim_opt)
    otype = o.pop("type", "Adam")
    if otype != "Adam":
        raise NotImplementedError(f"optimizer {otype} is not ported yet (only Adam)")
    betas = tuple(o.pop("betas", (0.9, 0.999)))
    return torch.optim.Adam(params, lr=schedule(0), betas=betas, eps=1e-8,
                            weight_decay=o.pop("weight_decay", 0))


def optimizer_step(opt: torch.optim.Optimizer, lr: float, apply: bool = True) -> None:
    """One optimizer update at ``lr``.  With ``apply`` False the moments still
    advance (with zero gradients) but the parameters keep their values: the
    JAX recipes' gate, which scales gradients and the update by 0."""
    params = [p for g in opt.param_groups for p in g["params"]]
    for g in opt.param_groups:
        g["lr"] = lr
    if apply:
        opt.step()
        return
    saved = [p.detach().clone() for p in params]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad.zero_()
    opt.step()
    with torch.no_grad():
        for p, s in zip(params, saved):
            p.copy_(s)


@torch.no_grad()
def ema_update(ema: nn.Module, net: nn.Module, decay: float) -> None:
    """net_g_ema = decay * ema + (1 - decay) * net_g (reference base_model.py:75-82)."""
    for pe, p in zip(ema.parameters(), net.parameters()):
        pe.copy_(pe * decay + p * (1.0 - decay))


def load_network(net: nn.Module, path: str, param_key: str = "params", strict: bool = True):
    """Load a reference-layout ``.pth`` (``{param_key: state_dict}`` or a bare
    state dict) into ``net``."""
    state = torch.load(path, map_location="cpu")
    if isinstance(state, dict) and param_key in state:
        state = state[param_key]
    net.load_state_dict(state, strict=strict)


class BaseModel:
    """Holds the static config, the device and the step function."""

    def __init__(self, opt: dict, device=None):
        self.opt = opt
        self.scale = opt.get("scale", 4)
        self.device = resolve_device(device)

    def build_g(self):
        net_opt = deepcopy(self.opt["network_g"])
        net_opt.setdefault("scale", self.scale)
        return build_network(net_opt)

