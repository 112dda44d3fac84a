"""SRGAN / ESRGAN recipes (reference: models/srgan_model.py, esrgan_model.py).

Counterpart of ``ssl_tpu/models/srgan_model.py``.  One step = a G phase and
a D phase, as the JAX step does them:

* G phase: the D runs in train mode (batch statistics) but its parameters get
  no gradient and its buffer updates (running stats, spectral norms' u and
  sigma) are discarded: the D phase owns them.  The fake and the real pass
  both start from the step's incoming buffers.  The G update is gated by ``net_d_iters``/``net_d_init_iters``;
  when the gate is off Adam's moments still advance with zero gradients.
* D phase: real then fake, serially, threading the running stats, on the SR
  of the G phase (computed with the pre-update G) detached.
* EMA of G after the G update."""

from __future__ import annotations

from contextlib import contextmanager
from copy import deepcopy

import torch

from ssl_tpu_torch.models.base_model import (TrainState, build_optimizer, ema_update,
                                             load_network, optimizer_step)
from ssl_tpu_torch.models.lr_scheduler import build_schedule
from ssl_tpu_torch.models.sr_model import SRModel
from ssl_tpu_torch.utils.registry import MODEL_REGISTRY, build_loss, build_network


@contextmanager
def frozen_discriminator(net_d):
    """D parameters take no gradient and its buffers (BN running stats) are
    restored on exit."""
    saved = [b.detach().clone() for b in net_d.buffers()]
    net_d.requires_grad_(False)
    try:
        yield
    finally:
        net_d.requires_grad_(True)
        with torch.no_grad():
            for b, s in zip(net_d.buffers(), saved):
                b.copy_(s)


@MODEL_REGISTRY.register()
class SRGANModel(SRModel):
    relativistic = False

    def __init__(self, opt: dict, device=None):
        super().__init__(opt, device=device)
        self.has_d = bool(opt.get("network_d")) and self.is_train
        train_opt = opt.get("train") or {}
        if self.has_d:
            self.schedule_d = build_schedule(train_opt, train_opt["optim_d"].get("lr", 1e-4))
            self.cri_gan = build_loss(train_opt["gan_opt"]) if train_opt.get("gan_opt") else None
            self.net_d_iters = train_opt.get("net_d_iters", 1)
            self.net_d_init_iters = train_opt.get("net_d_init_iters", 0)
        if train_opt.get("fuse_d_batch", False):
            raise NotImplementedError("train.fuse_d_batch is a TPU dispatch knob; not ported")

    # -------------------------------------------------------------- state init
    def init_state(self, seed: int = 0) -> TrainState:
        state = super().init_state(seed)
        if not self.has_d:
            return state
        net_d = self.build_d(self.opt["network_d"], seed + 1)
        path = (self.opt.get("path") or {})
        if path.get("pretrain_network_d"):
            load_network(net_d, path["pretrain_network_d"], path.get("param_key_d", "params"),
                         path.get("strict_load_d", True))
        state.net_d = net_d.to(self.device).train()
        state.opt_d = build_optimizer(self.train_opt["optim_d"], state.net_d.parameters(),
                                      self.schedule_d)
        return state

    def build_d(self, net_opt: dict, seed: int):
        """The D of the option dict ``net_opt``, its weights drawn from ``seed``."""
        net_d = build_network(deepcopy(net_opt))
        net_d.reset_parameters(torch.Generator().manual_seed(seed))
        return net_d

    # ---------------------------------------------------------------- GAN terms
    def gan_g_loss(self, fake_pred, real_pred):
        if self.relativistic:
            real_pred = real_pred.detach()
            l_g_real = self.cri_gan(real_pred - torch.mean(fake_pred), False, is_disc=False)
            l_g_fake = self.cri_gan(fake_pred - torch.mean(real_pred), True, is_disc=False)
            return (l_g_real + l_g_fake) / 2
        return self.cri_gan(fake_pred, True, is_disc=False)

    def gan_d_loss(self, real_pred, fake_pred):
        if self.relativistic:
            l_d_real = self.cri_gan(real_pred - torch.mean(fake_pred.detach()),
                                    True, is_disc=True) * 0.5
            l_d_fake = self.cri_gan(fake_pred - torch.mean(real_pred.detach()),
                                    False, is_disc=True) * 0.5
        else:
            l_d_real = self.cri_gan(real_pred, True, is_disc=True)
            l_d_fake = self.cri_gan(fake_pred, False, is_disc=True)
        return l_d_real + l_d_fake, {"l_d_real": l_d_real, "l_d_fake": l_d_fake}

    # -------------------------------------------------- generator loss (hook)
    def g_losses_gan(self, state: TrainState, batch: dict):
        """Pixel (+ recipe extras) + perceptual + GAN."""
        total, logs, sr = self.g_losses(state, batch)
        if self.cri_gan is not None:
            # each pass from the pre-step buffers, as the JAX step applies D
            # to both with the incoming stats (spectral norms' u moves D)
            with frozen_discriminator(state.net_d):
                fake_pred = state.net_d(sr)
            with frozen_discriminator(state.net_d):
                real_pred = state.net_d(batch["gt"])
            l_g_gan = self.gan_g_loss(fake_pred, real_pred.detach())
            total = total + l_g_gan
            logs["l_g_gan"] = l_g_gan
        return total, logs, sr

    # --------------------------------------------------- discriminator loss
    def d_losses(self, state: TrainState, batch: dict, sr_detached):
        real_pred = state.net_d(batch["gt"])
        fake_pred = state.net_d(sr_detached)
        loss, d_logs = self.gan_d_loss(real_pred, fake_pred)
        d_logs["out_d_real"] = torch.mean(real_pred.detach())
        d_logs["out_d_fake"] = torch.mean(fake_pred.detach())
        return loss, d_logs

    # -------------------------------------------------------------- train step
    def make_train_step(self):
        if not self.has_d:
            return super().make_train_step()

        def step_fn(state: TrainState, batch: dict):
            it = state.step + 1

            # ---------------- G phase
            state.opt_g.zero_grad(set_to_none=True)
            l_g_total, logs, sr = self.g_losses_gan(state, batch)
            l_g_total.backward()
            do_g = it % self.net_d_iters == 0 and it > self.net_d_init_iters
            optimizer_step(state.opt_g, self.schedule_g(state.step), apply=do_g)

            # ---------------- D phase
            state.opt_d.zero_grad(set_to_none=True)
            l_d, d_logs = self.d_losses(state, batch, sr.detach())
            l_d.backward()
            optimizer_step(state.opt_d, self.schedule_d(state.step))

            if self.ema_decay > 0:
                ema_update(state.net_g_ema, state.net_g, self.ema_decay)

            logs.update(d_logs)
            logs["l_g_total"] = l_g_total
            logs["lr"] = self.schedule_g(state.step)
            state.step = it
            return state, {k: (v.detach() if torch.is_tensor(v) else v) for k, v in logs.items()}
        return step_fn


@MODEL_REGISTRY.register()
class ESRGANModel(SRGANModel):
    """Relativistic-GAN variant (reference models/esrgan_model.py)."""
    relativistic = True
