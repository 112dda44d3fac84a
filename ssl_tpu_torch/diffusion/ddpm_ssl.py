"""StableSR-SSL latent diffusion: the configuration and the serving half.

Counterpart of ``ssl_tpu/diffusion/ddpm_ssl.py``.  The JAX package keeps the
state as a pytree of parameters applied to stateless flax modules; here the
state holds the modules themselves, with their parameters:

    JAX DiffusionTrainState      DiffusionState here
    params['unet']               params['unet']        UNetModelDualcondV2
    params['structcond']         params['structcond']  EncoderUNetModelWT
    params['null_context']       params['null_context'] (context_len, context_dim)
    frozen['vae']                frozen['vae']          AutoencoderKL
    ema_params                   ema_params (a copy of params at init)
    step, rng, opt_state         step (the optimizer comes with training)

The text context is the learned null context (no CLIP weights are in the
repository).  The train step waits for the training slice and raises."""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from ssl_tpu_torch.diffusion.schedules import (DiffusionSchedule, build_schedule_arrays,
                                               make_beta_schedule)
from ssl_tpu_torch.diffusion.unet import (EncoderUNetModelWT, UNetModelDualcondV2,
                                          init_params)
from ssl_tpu_torch.diffusion.vae import AutoencoderKL
from ssl_tpu_torch.models.base_model import resolve_device

TRAINING_SLICE = ("the diffusion train step is not ported yet: it comes with the diffusion "
                  "training slice (ROADMAP.md, queue 1 item 1)")


class DiffusionSSLConfig(NamedTuple):
    timesteps: int = 1000
    beta_schedule: str = "linear"
    linear_start: float = 0.00085
    linear_end: float = 0.012
    parameterization: str = "eps"        # 'eps' | 'x0' | 'v'
    scale_factor: float = 0.18215        # latent scaling (SD convention)
    pixel_weight: float = 0.1
    ssl_l1_weight: float = 0.5
    ssl_kl_weight: float = 0.5
    context_dim: int = 1024
    context_len: int = 77
    learn_logvar: bool = False


@dataclass
class DiffusionState:
    step: int
    params: dict                     # {'unet', 'structcond', 'null_context'}
    frozen: dict                     # {'vae'}: the first stage is frozen
    ema_params: dict | None = None


def _materialize(template: nn.Module, device, generator) -> nn.Module:
    """A fresh copy of ``template`` on ``device`` with seeded weights (the
    template may live on the meta device and hold no memory)."""
    return init_params(copy.deepcopy(template).to_empty(device=device), generator)


class StableSRSSL:
    """Holds the configuration and the three networks' definitions; the
    weights live in the state that ``init_state`` makes.  The training
    options of the JAX class (SSL setting, learning rate, accumulation, EMA
    decay) come with the train step."""

    def __init__(self, cfg: DiffusionSSLConfig = DiffusionSSLConfig(),
                 unet: UNetModelDualcondV2 | None = None,
                 structcond: EncoderUNetModelWT | None = None,
                 vae: AutoencoderKL | None = None, vae_ckpt: str | None = None,
                 clip_text_ckpt: str | None = None, unet_ckpt: str | None = None,
                 text_prompt: str | None = None, use_ema: bool = True):
        for name, value in (("vae_ckpt", vae_ckpt), ("clip_text_ckpt", clip_text_ckpt),
                            ("unet_ckpt", unet_ckpt), ("text_prompt", text_prompt)):
            if value:
                raise NotImplementedError(f"{name} is not ported yet (ROADMAP.md, queue 1): no "
                                          "such weight file is in the repository")
        self.cfg = cfg
        with torch.device("meta"):
            self.unet = unet or UNetModelDualcondV2(context_dim=cfg.context_dim)
            self.structcond = structcond or EncoderUNetModelWT()
            self.vae = vae or AutoencoderKL()
        self.use_ema = use_ema
        self.sched: DiffusionSchedule = build_schedule_arrays(
            make_beta_schedule(cfg.beta_schedule, cfg.timesteps, cfg.linear_start, cfg.linear_end))

    def init_state(self, seed: int = 0, device=None) -> DiffusionState:
        """Seeded weights on ``device`` (``cuda`` unless the caller names
        another): lecun-normal convs and linears, the layers the JAX package
        zero-initialises at 0, the null context ~ N(0, 0.02^2), and the EMA a
        copy of the weights."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        vae = _materialize(self.vae, device, gen).requires_grad_(False)
        params = {
            "unet": _materialize(self.unet, device, gen),
            "structcond": _materialize(self.structcond, device, gen),
            "null_context": torch.randn((self.cfg.context_len, self.cfg.context_dim),
                                        generator=gen, device=device) * 0.02,
        }
        ema = copy.deepcopy(params) if self.use_ema else None
        return DiffusionState(step=0, params=params, frozen={"vae": vae}, ema_params=ema)

    def infer_params(self, state: DiffusionState) -> dict:
        """Sampling-time weights: the EMA when tracked (the reference samples
        under LitEma's ema_scope)."""
        return state.ema_params if state.ema_params is not None else state.params

    def encode(self, vae: AutoencoderKL, img: torch.Tensor, generator=None, noise=None):
        """[-1, 1] image (b, 3, h, w) -> scaled latent sample.  The posterior
        noise is drawn from ``generator`` unless ``noise`` is given."""
        mean, logvar = vae.encode(img)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        return (mean + torch.exp(0.5 * logvar) * noise) * self.cfg.scale_factor

    def decode(self, vae: AutoencoderKL, z: torch.Tensor) -> torch.Tensor:
        return vae.decode(z / self.cfg.scale_factor)

    def apply_model(self, params: dict, z_noisy, t, context, z_lq):
        feats = params["structcond"](z_lq, t)
        return params["unet"](z_noisy, t, context, feats)

    def make_train_step(self):
        raise NotImplementedError(TRAINING_SLICE)

    def train_step(self, state, batch):
        raise NotImplementedError(TRAINING_SLICE)
