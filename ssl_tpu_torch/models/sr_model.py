"""SRModel — the base SR training recipe (reference: models/sr_model.py).

Counterpart of the training half of ``ssl_tpu/models/sr_model.py``: pixel +
optional perceptual loss, Adam with a step schedule, EMA.  Validation,
tiled inference and checkpoint I/O are later slices (ROADMAP.md)."""

from __future__ import annotations

from copy import deepcopy

import torch

from ssl_tpu_torch.models.base_model import (BaseModel, TrainState, build_optimizer,
                                             ema_update, load_network, optimizer_step)
from ssl_tpu_torch.models.lr_scheduler import build_schedule
from ssl_tpu_torch.utils.registry import MODEL_REGISTRY, build_loss


@MODEL_REGISTRY.register()
class SRModel(BaseModel):

    def __init__(self, opt: dict, device=None):
        super().__init__(opt, device=device)
        train_opt = opt.get("train") or {}
        self.train_opt = train_opt
        self.ema_decay = train_opt.get("ema_decay", 0)
        self.schedule_g = build_schedule(train_opt, train_opt["optim_g"].get("lr", 1e-4))
        self.cri_pix = build_loss(train_opt["pixel_opt"]) if train_opt.get("pixel_opt") else None
        self.cri_perceptual = (build_loss(train_opt["perceptual_opt"]).to(self.device)
                               if train_opt.get("perceptual_opt") else None)
        if self.cri_pix is None and self.cri_perceptual is None:
            raise ValueError("Both pixel and perceptual losses are None.")

    # -------------------------------------------------------------- state init
    def init_state(self, seed: int = 0) -> TrainState:
        """G weights from a ``torch.Generator`` seeded with ``seed`` (or the
        configured pretrain file), Adam, and an EMA copy."""
        net_g = self.build_g()
        net_g.reset_parameters(torch.Generator().manual_seed(seed))
        path = (self.opt.get("path") or {})
        if path.get("pretrain_network_g"):
            load_network(net_g, path["pretrain_network_g"], path.get("param_key_g", "params"),
                         path.get("strict_load_g", True))
        net_g = net_g.to(self.device).train()
        opt_g = build_optimizer(self.train_opt["optim_g"], net_g.parameters(), self.schedule_g)
        ema = None
        if self.ema_decay > 0:
            ema = deepcopy(net_g).requires_grad_(False)
        return TrainState(step=0, net_g=net_g, opt_g=opt_g, net_g_ema=ema)

    # ------------------------------------------------------------------ losses
    def g_losses(self, state: TrainState, batch: dict):
        sr = state.net_g(batch["lq"])
        total = sr.new_zeros(())
        logs = {}
        if self.cri_pix is not None:
            l_pix = self.cri_pix(sr, batch["gt"])
            total = total + l_pix
            logs["l_pix"] = l_pix
        if self.cri_perceptual is not None:
            l_percep, l_style = self.cri_perceptual(sr, batch["gt"])
            total = total + l_percep + l_style
            logs["l_percep"] = l_percep
        return total, logs, sr

    # -------------------------------------------------------------- train step
    def to_device(self, batch: dict) -> dict:
        return {k: (v.to(self.device) if torch.is_tensor(v) else v) for k, v in batch.items()}

    def make_train_step(self):
        def step_fn(state: TrainState, batch: dict):
            state.opt_g.zero_grad(set_to_none=True)
            total, logs, _ = self.g_losses(state, batch)
            total.backward()
            optimizer_step(state.opt_g, self.schedule_g(state.step))
            if self.ema_decay > 0:
                ema_update(state.net_g_ema, state.net_g, self.ema_decay)
            logs["l_total"] = total
            logs["lr"] = self.schedule_g(state.step)
            state.step += 1
            return state, {k: (v.detach() if torch.is_tensor(v) else v) for k, v in logs.items()}
        return step_fn

    def train_step(self, state: TrainState, batch: dict):
        """One optimization step; updates ``state`` in place and returns
        ``(state, logs)``."""
        return self.make_train_step()(state, self.to_device(batch))
