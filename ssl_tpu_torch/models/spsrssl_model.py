"""SPSR-SSL: the dual-branch generator, an image D, a gradient D and SSL
(reference: models/spsrssl_model.py:96-736).

Counterpart of ``ssl_tpu/models/spsrssl_model.py``.  G's losses: pixel L1
on SR, the L1 between the gradient maps of SR and GT
(``gradient_pixel_opt``) and between the gradient branch's output and GT's
gradient map (``gradient_branch_opt``), SSL on SR, perceptual, and the
relativistic GAN terms of the image D and of the gradient D
(``network_d_grad``, on gradient maps).  The gradient D lives in
``TrainState.nets["net_d_grad"]`` (its weights from seed + 3); one Adam
updates both D's, as the JAX step's ``params_d = {'img', 'grad'}``.

Where the step differs from ESRGAN-SSL's:

* when ``net_d_iters`` / ``net_d_init_iters`` gate G off, G's parameters
  *and* its Adam moments keep their values (the JAX step selects the old
  state wholesale; ESRGAN-SSL's advances the moments with zero gradients);
* with ``Branch_pretrain``, for the first ``Branch_init_iters`` iterations
  only the fusion parameters (``f_*``) move; the others keep their values
  while Adam's moments advance, as the JAX step reverts the parameters only;
* the D phase runs the image D on real then fake, and the gradient D on the
  real then the fake gradient maps, each threading its own statistics;
* inference takes the SR image, the generator's second output."""

from __future__ import annotations

import torch

from ssl_tpu_torch.archs.spsr_arch import image_gradient
from ssl_tpu_torch.losses.ssl_loss import ssl_loss
from ssl_tpu_torch.models.base_model import build_optimizer, ema_update, optimizer_step
from ssl_tpu_torch.models.esrganssl_model import ESRGANSSLModel
from ssl_tpu_torch.models.srgan_model import frozen_discriminator
from ssl_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class SPSRSSLModel(ESRGANSSLModel):
    # its own step applies the two Ds in place: under a process group it
    # raises (ROADMAP.md, queue 1 item 10)
    data_parallel = False

    def __init__(self, opt: dict, device=None):
        super().__init__(opt, device=device)
        train_opt = opt.get("train") or {}
        self.has_d_grad = self.has_d and bool(opt.get("network_d_grad"))
        self.grad_pix_weight = (train_opt.get("gradient_pixel_opt") or {}).get("loss_weight", 1.0)
        self.grad_branch_weight = \
            (train_opt.get("gradient_branch_opt") or {}).get("loss_weight", 0.5)
        self.branch_pretrain = bool(train_opt.get("Branch_pretrain", 0))
        self.branch_init_iters = int(train_opt.get("Branch_init_iters", 5000))

    def init_state(self, seed: int = 0):
        state = super().init_state(seed)
        if self.has_d_grad:
            net = self.build_d(self.opt["network_d_grad"], seed + 3).to(self.device).train()
            state.nets["net_d_grad"] = net
            state.opt_d = build_optimizer(
                self.train_opt["optim_d"],
                list(state.net_d.parameters()) + list(net.parameters()), self.schedule_d)
        return state

    def infer(self, net, lq):
        return net(lq)[1]

    def g_losses_gan(self, state, batch):
        out_branch, sr, _ = state.net_g(batch["lq"])
        gt = batch["gt"]
        gt_grad, sr_grad = image_gradient(gt), image_gradient(sr)
        total = sr.new_zeros(())
        logs = {}
        if self.cri_pix is not None:
            l_pix = self.cri_pix(sr, gt)
            total = total + l_pix
            logs["l_pix"] = l_pix
        l_grad_pix = self.grad_pix_weight * torch.mean(torch.abs(sr_grad - gt_grad))
        l_grad_branch = self.grad_branch_weight * torch.mean(torch.abs(out_branch - gt_grad))
        total = total + l_grad_pix + l_grad_branch
        logs["l_g_grad_pix"] = l_grad_pix
        logs["l_g_grad_branch"] = l_grad_branch
        if self.use_ssl and "gt_mask" in batch:
            l_ss, l_kl = ssl_loss(sr, gt, batch["gt_mask"], self.ssl_setting, self.mesh)
            if self.ssl_setting.l1_weight > 0:
                total = total + l_ss
                logs["l_selfsim"] = l_ss
            if self.ssl_setting.kl_weight > 0:
                total = total + l_kl
                logs["l_selfsim_kl"] = l_kl
        if self.cri_perceptual is not None:
            l_percep, l_style = self.cri_perceptual(sr, gt)
            total = total + l_percep + l_style
            logs["l_percep"] = l_percep
        if self.cri_gan is not None:
            pairs = [("l_g_gan", state.net_d, sr, gt)]
            if self.has_d_grad:
                pairs.append(("l_g_gan_grad", state.nets["net_d_grad"], sr_grad, gt_grad))
            for key, net_d, fake, real in pairs:
                # each pass from the pre-step buffers, as in SRGANModel
                with frozen_discriminator(net_d):
                    fake_pred = net_d(fake)
                with frozen_discriminator(net_d):
                    real_pred = net_d(real)
                loss = self.gan_g_loss(fake_pred, real_pred.detach())
                total = total + loss
                logs[key] = loss
        return total, logs, sr

    def make_train_step(self):
        if not self.has_d_grad:
            return super().make_train_step()
        train_opt = self.train_opt
        net_d_iters = int(train_opt.get("net_d_iters", 1))
        net_d_init_iters = int(train_opt.get("net_d_init_iters", 0))

        def step_fn(state, batch):
            it = state.step + 1
            net_d_grad = state.nets["net_d_grad"]

            # ---------------- G phase
            state.opt_g.zero_grad(set_to_none=True)
            l_g_total, logs, sr = self.g_losses_gan(state, batch)
            l_g_total.backward()
            if it % net_d_iters == 0 and it > net_d_init_iters:
                held = []
                if self.branch_pretrain and it <= self.branch_init_iters:
                    held = [(p, p.detach().clone()) for n, p in state.net_g.named_parameters()
                            if not n.startswith("f_")]
                optimizer_step(state.opt_g, self.schedule_g(state.step))
                with torch.no_grad():
                    for p, old in held:
                        p.copy_(old)

            # ---------------- D phase: both D's, one Adam
            state.opt_d.zero_grad(set_to_none=True)
            sr_d, gt = sr.detach(), batch["gt"]
            l_i, d_logs = self.gan_d_loss(state.net_d(gt), state.net_d(sr_d))
            l_g, g_logs = self.gan_d_loss(net_d_grad(image_gradient(gt)),
                                          net_d_grad(image_gradient(sr_d)))
            (l_i + l_g).backward()
            optimizer_step(state.opt_d, self.schedule_d(state.step))

            if self.ema_decay > 0:
                ema_update(state.net_g_ema, state.net_g, self.ema_decay)
            logs.update(d_logs)
            logs["l_d_real_grad"] = g_logs["l_d_real"]
            logs["l_d_fake_grad"] = g_logs["l_d_fake"]
            logs["l_g_total"] = l_g_total
            logs["lr"] = self.schedule_g(state.step)
            state.step = it
            return state, {k: (v.detach() if torch.is_tensor(v) else v) for k, v in logs.items()}
        return step_fn
