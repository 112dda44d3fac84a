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
    extra                     extra (recipe state: RealESRGAN's pool and generators,
                              RankSRGAN's frozen Ranker)
    params_d['grad'] (SPSR)   nets['net_d_grad'] (a recipe's further trained nets)

The JAX ``rng`` has no counterpart: ESRGAN-SSL draws no random numbers
during a step, and RealESRGAN's draws come from the generators in
``extra``.  Without training (``is_train: false``) the
state holds only ``net_g`` (and its EMA when ``ema_decay`` is set).

Checkpoints: ``save_networks`` writes ``net_g_{iter}.pth`` ({"params",
"params_ema"}), ``net_d_{iter}.pth`` ({"params"}) and one such file for each
of ``nets`` (SPSR's ``net_d_grad_{iter}.pth``) in the reference's layout;
``save_training_state`` writes ``training_states/{iter}.state``
(``torch.save`` of every net, the EMA, both optimizers, the step, ``extra``,
the recipe's ``host_state`` and the torch / CUDA / numpy / ``random``
generator states; the schedules are functions of the step) and the
``latest`` file."""

from __future__ import annotations

import os
import pickle
import random
from copy import deepcopy
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
from torch import nn

from ssl_tpu_torch.utils.registry import build_model, build_network  # noqa: F401
from ssl_tpu_torch.utils.weight_port import FAMILIES, params_from_jax

# TrainState fields saved in a training state, with their kinds
_NETS = ("net_g", "net_g_ema", "net_d")
_OPTIMIZERS = ("opt_g", "opt_d")


@dataclass
class TrainState:
    step: int
    net_g: nn.Module
    opt_g: torch.optim.Optimizer | None = None
    net_g_ema: nn.Module | None = None
    net_d: nn.Module | None = None
    opt_d: torch.optim.Optimizer | None = None
    extra: dict | None = None       # tensors, ints, torch.Generators and frozen modules
    nets: dict = field(default_factory=dict)    # further trained nets by name, opt_d's too


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device.  There is no silent
    CPU run: without a CUDA device the default fails."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the port runs on cuda unless "
                           "the caller passes device='cpu'")
    return dev


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop`` at its defaults: nu = (1 - decay) g^2 + decay nu
    from nu = 0, and p -= lr g / sqrt(nu + eps), eps inside the root (torch's
    ``RMSprop`` adds it outside)."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1 - group["decay"]) * p.grad * p.grad + group["decay"] * nu)
                p.add_(p.grad * torch.rsqrt(nu + group["eps"]), alpha=-group["lr"])


def build_optimizer(optim_opt: dict, params, schedule: Callable):
    """Optimizer factory (reference base_model.py:103-120) with the update
    rules of the JAX package's optax transforms; the learning rate is written
    from ``schedule`` at every step.

    * Adam: ``optax.adam``, after ``add_decayed_weights`` when
      ``weight_decay`` is set (torch's L2 term adds wd p to the gradient);
    * AdamW: ``optax.adamw`` (decoupled decay, 0 unless set);
    * SGD: ``optax.sgd`` with ``momentum`` (a trace from 0, no dampening);
    * RMSprop: ``optax.rmsprop`` (``RMSprop`` above);
    * Adamax: ``optax.adamax`` (|g| + eps inside the running maximum, as
      torch's ``Adamax`` does).

    Like the JAX factory, SGD, RMSprop and Adamax ignore ``weight_decay``."""
    o = deepcopy(optim_opt)
    otype = o.pop("type", "Adam")
    betas = tuple(o.pop("betas", (0.9, 0.999)))
    wd = o.pop("weight_decay", 0)
    lr = schedule(0)
    if otype == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8, weight_decay=wd)
    if otype == "AdamW":
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8, weight_decay=wd)
    if otype == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=o.pop("momentum", 0.0))
    if otype == "RMSprop":
        return RMSprop(params, lr=lr)
    if otype == "Adamax":
        return torch.optim.Adamax(params, lr=lr, betas=betas, eps=1e-8)
    raise NotImplementedError(f"optimizer {otype} is not supported yet.")


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
    """Load weights into ``net``: a reference-layout ``.pth``
    (``{param_key: state_dict}`` or a bare state dict), or the JAX package's
    ``net_*_{iter}.pkl`` (``{param_key: flax params}``), carried across by
    ``params_from_jax`` for the net's class.  A ``.pkl`` holds no batch-norm
    statistics, so those buffers keep their values; every parameter must
    load."""
    if not path.endswith((".pkl", ".pickle")):
        state = torch.load(path, map_location="cpu")
        if isinstance(state, dict) and param_key in state:
            state = state[param_key]
        net.load_state_dict(state, strict=strict)
        return
    family = type(net).__name__
    if family not in FAMILIES:
        raise ValueError(f"{path}: no weight carry from the JAX package for {family}")
    with open(path, "rb") as f:
        payload = pickle.load(f)
    tree = payload.get(param_key, payload) if isinstance(payload, dict) else payload
    missing, unexpected = net.load_state_dict(params_from_jax(family, tree), strict=False)
    params = dict(net.named_parameters())
    if unexpected or any(k in params for k in missing):
        raise ValueError(f"{path}: {family} weights do not match: missing "
                         f"{[k for k in missing if k in params]}, unexpected {unexpected}")


def _rng_state() -> dict:
    name, keys, pos, has_gauss, gauss = np.random.get_state()
    return {"torch": torch.get_rng_state(),
            "cuda": torch.cuda.get_rng_state_all() if torch.cuda.is_available() else [],
            "numpy": (name, torch.from_numpy(keys.astype(np.int64)), pos, has_gauss, gauss),
            "random": random.getstate()}


def _set_rng_state(rng: dict) -> None:
    torch.set_rng_state(rng["torch"])
    if rng["cuda"]:
        torch.cuda.set_rng_state_all(rng["cuda"])
    name, keys, pos, has_gauss, gauss = rng["numpy"]
    np.random.set_state((name, keys.numpy().astype(np.uint32), pos, has_gauss, gauss))
    version, internal, gauss_next = rng["random"]
    random.setstate((version, tuple(internal), gauss_next))


def _host_state_dict(net: nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in net.state_dict().items()}


def _host_extra(extra: dict | None) -> dict | None:
    """``TrainState.extra`` as ``torch.load(weights_only=True)`` reads it: a
    generator as its state, a module as its state dict on the host, a tensor
    on the host, an int as it is."""
    if extra is None:
        return None
    return {k: v.get_state() if isinstance(v, torch.Generator) else
            _host_state_dict(v) if isinstance(v, nn.Module) else
            v.detach().cpu() if torch.is_tensor(v) else v for k, v in extra.items()}


def _load_extra(extra: dict, saved: dict, device) -> None:
    """Restore ``_host_extra``'s output into ``extra`` in place: generators
    take their saved state, modules their state dict, tensors go to
    ``device``."""
    for k, v in saved.items():
        if isinstance(extra.get(k), torch.Generator):
            extra[k].set_state(v)
        elif isinstance(extra.get(k), nn.Module):
            extra[k].load_state_dict(v)
        else:
            extra[k] = v.to(device) if torch.is_tensor(v) else v


class BaseModel:
    """Holds the static config, the device and the step function."""

    def __init__(self, opt: dict, device=None):
        self.opt = opt
        self.is_train = opt.get("is_train", True)
        self.scale = opt.get("scale", 4)
        self.device = resolve_device(device)

    def build_g(self):
        net_opt = deepcopy(self.opt["network_g"])
        net_opt.setdefault("scale", self.scale)
        return build_network(net_opt)

    # ------------------------------------------------------------ persistence
    def host_state(self) -> dict:
        """State on the host that the training state carries besides the
        nets (RealESRGAN's host degrader); none by default."""
        return {}

    def set_host_state(self, hs: dict) -> None:
        """Restore what ``host_state`` gave."""

    def save_networks(self, state: TrainState, save_dir: str, current_iter: int) -> None:
        """``net_g_{iter}.pth`` ({"params", "params_ema"}) and, with a D,
        ``net_d_{iter}.pth`` ({"params"}) and ``{name}_{iter}.pth`` for each
        of ``state.nets``, as the reference saves them."""
        os.makedirs(save_dir, exist_ok=True)
        payload = {"params": _host_state_dict(state.net_g)}
        if state.net_g_ema is not None:
            payload["params_ema"] = _host_state_dict(state.net_g_ema)
        torch.save(payload, os.path.join(save_dir, f"net_g_{current_iter}.pth"))
        for name, net in (("net_d", state.net_d), *state.nets.items()):
            if net is not None:
                torch.save({"params": _host_state_dict(net)},
                           os.path.join(save_dir, f"{name}_{current_iter}.pth"))

    def save_training_state(self, state: TrainState, state_dir: str, epoch: int,
                            current_iter: int) -> None:
        os.makedirs(state_dir, exist_ok=True)
        payload = {"iter": current_iter, "epoch": epoch, "step": state.step,
                   "rng": _rng_state(), "extra": _host_extra(state.extra),
                   "host": self.host_state()}
        for name in _NETS:
            net = getattr(state, name)
            payload[name] = None if net is None else _host_state_dict(net)
        for name, net in state.nets.items():
            payload[name] = _host_state_dict(net)
        for name in _OPTIMIZERS:
            optim = getattr(state, name)
            payload[name] = None if optim is None else optim.state_dict()
        torch.save(payload, os.path.join(state_dir, f"{current_iter}.state"))
        with open(os.path.join(state_dir, "latest"), "w") as f:
            f.write(str(current_iter))

    def load_training_state(self, state: TrainState, state_dir: str,
                            current_iter: int | str = "latest"):
        """Load ``{current_iter}.state`` into ``state`` (in place) and restore
        the generators; returns ``(state, iter)``."""
        if current_iter == "latest":
            with open(os.path.join(state_dir, "latest")) as f:
                current_iter = int(f.read().strip())
        payload = torch.load(os.path.join(state_dir, f"{current_iter}.state"),
                             map_location="cpu", weights_only=True)
        for name in _NETS + _OPTIMIZERS:
            have, saved = getattr(state, name), payload[name]
            if (have is None) != (saved is None):
                raise ValueError(f"training state {current_iter}: {name} is "
                                 f"{'absent' if saved is None else 'present'} in the file "
                                 "but not in the model")
            if have is not None:
                have.load_state_dict(saved)
        for name, net in state.nets.items():
            if payload.get(name) is None:
                raise ValueError(f"training state {current_iter}: {name} is absent from the file")
            net.load_state_dict(payload[name])
        saved_extra = payload.get("extra")         # absent from states of earlier versions
        if (state.extra is None) != (saved_extra is None):
            raise ValueError(f"training state {current_iter}: extra does not match the model's")
        if state.extra is not None:
            _load_extra(state.extra, saved_extra, self.device)
        if payload.get("host"):                    # absent from states of earlier versions
            self.set_host_state(payload["host"])
        state.step = int(payload["step"])
        _set_rng_state(payload["rng"])
        return state, int(payload["iter"])

    @staticmethod
    def find_latest_state(state_dir: str) -> int | None:
        """auto_resume: the largest saved iteration (reference train.py:68-88)."""
        if not os.path.isdir(state_dir):
            return None
        iters = [int(f[:-len(".state")]) for f in os.listdir(state_dir)
                 if f.endswith(".state") and f[:-len(".state")].isdigit()]
        return max(iters) if iters else None

