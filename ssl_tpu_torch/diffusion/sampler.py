"""Samplers: spaced ancestral DDPM, DDIM, PLMS, and the Gaussian-weighted
tiled latent canvas.

Counterpart of ``ssl_tpu/diffusion/sampler.py``.  The JAX package runs each
loop under ``lax.scan``; here it is a Python loop under ``torch.no_grad``, one
``apply_model`` call (a struct-cond encoder and a UNet forward) per step.
Latents are NCHW.  Noise comes from a ``torch.Generator``; a caller may give
the initial latent (``x_init``) and, for the ancestral DDPM, the per-step
noise (``noises``) instead, which is how the CPU tests feed both packages
the same numbers.  The schedule's scalars are float32, as in JAX."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ssl_tpu_torch.diffusion.schedules import DiffusionSchedule, space_timesteps


def _start(shape, generator, device, x_init):
    if x_init is not None:
        return x_init.to(device)
    return torch.randn(shape, generator=generator, device=device)


def _timestep(t: int, b: int, device) -> torch.Tensor:
    return torch.full((b,), int(t), dtype=torch.long, device=device)


def _reversed_pairs(sched: DiffusionSchedule, steps: int):
    """(t, t_prev) from the last spaced timestep down, t_prev -1 at the end."""
    t_seq = space_timesteps(sched.num_timesteps, steps)[::-1]
    return list(zip(t_seq, t_seq[1:] + [-1]))


@torch.no_grad()
def ddim_sample(apply_model: Callable, sched: DiffusionSchedule, shape, generator, context,
                z_lq, steps: int = 50, eta: float = 0.0, parameterization: str = "eps",
                x_init: torch.Tensor | None = None):
    """DDIM sampling (ldm/models/diffusion/ddim.py)."""
    device = z_lq.device
    x = _start(shape, generator, device, x_init)
    ac, one = sched.alphas_cumprod, torch.ones((), dtype=torch.float32)
    for t, t_prev in _reversed_pairs(sched, steps):
        eps = apply_model(x, _timestep(t, x.shape[0], device), context, z_lq)
        a_t = ac[t]
        a_prev = ac[t_prev] if t_prev >= 0 else one
        if parameterization == "v":
            x0 = torch.sqrt(a_t) * x - torch.sqrt(1 - a_t) * eps
            eps = (x - torch.sqrt(a_t) * x0) / torch.sqrt(1 - a_t)
        else:
            x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        sigma = eta * torch.sqrt((1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev))
        dir_xt = torch.sqrt(torch.clamp(1 - a_prev - sigma ** 2, min=0.0)) * eps
        x = torch.sqrt(a_prev) * x0 + dir_xt
        if eta:
            x = x + sigma * torch.randn(x.shape, generator=generator, device=device)
    return x


@torch.no_grad()
def plms_sample(apply_model: Callable, sched: DiffusionSchedule, shape, generator, context,
                z_lq, steps: int = 50, parameterization: str = "eps",
                x_init: torch.Tensor | None = None):
    """PLMS (ldm/models/diffusion/plms.py:173-235): Adams-Bashforth on the eps
    predictions, orders 2 to 4 as history accumulates; the first step is the
    pseudo improved Euler with a second model evaluation.  Deterministic."""
    if steps < 2:
        raise ValueError("PLMS needs at least 2 steps")
    device = z_lq.device
    ac, one = sched.alphas_cumprod, torch.ones((), dtype=torch.float32)

    def eps_of(x, t):
        out = apply_model(x, _timestep(t, x.shape[0], device), context, z_lq)
        if parameterization == "v":
            a_t = ac[t]
            x0 = torch.sqrt(a_t) * x - torch.sqrt(1 - a_t) * out
            out = (x - torch.sqrt(a_t) * x0) / torch.sqrt(1 - a_t)
        return out

    def x_prev_of(x, e, t, t_prev):
        a_t = ac[t]
        a_prev = ac[t_prev] if t_prev >= 0 else one
        x0 = (x - torch.sqrt(1 - a_t) * e) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * e

    pairs = _reversed_pairs(sched, steps)
    x = _start(shape, generator, device, x_init)
    t0, t1 = pairs[0]
    e0 = eps_of(x, t0)
    e_next = eps_of(x_prev_of(x, e0, t0, t1), t1)
    x = x_prev_of(x, (e0 + e_next) / 2.0, t0, t1)
    hist = [e0, e0, e0]                                  # newest first
    for i, (t, t_prev) in enumerate(pairs[1:], start=1):
        e_t = eps_of(x, t)
        order = min(i - 1, 2)
        if order == 0:
            e_prime = (3 * e_t - hist[0]) / 2
        elif order == 1:
            e_prime = (23 * e_t - 16 * hist[0] + 5 * hist[1]) / 12
        else:
            e_prime = (55 * e_t - 59 * hist[0] + 37 * hist[1] - 9 * hist[2]) / 24
        x = x_prev_of(x, e_prime, t, t_prev)
        hist = [e_t, hist[0], hist[1]]
    return x


def _respaced_betas(sched: DiffusionSchedule, timesteps) -> np.ndarray:
    """Betas of the spaced chain, from the float32 alphas_cumprod."""
    ac = sched.alphas_cumprod.numpy()
    last, betas = 1.0, []
    for t in timesteps:
        betas.append(1 - ac[t] / last)
        last = ac[t]
    return np.asarray(betas, np.float32)


@torch.no_grad()
def spaced_ddpm_sample(apply_model: Callable, sched: DiffusionSchedule, shape, generator,
                       context, z_lq, steps: int = 200, x_init: torch.Tensor | None = None,
                       noises: Sequence[torch.Tensor] | None = None):
    """Spaced ancestral DDPM sampling (the reference test.py; ddpm_steps 200
    there).  ``noises``, if given, holds one noise tensor per step, first
    step first; the last step adds none."""
    timesteps = space_timesteps(sched.num_timesteps, steps)
    n = len(timesteps)
    betas = torch.from_numpy(_respaced_betas(sched, timesteps))
    alphas = 1 - betas
    ac = torch.from_numpy(np.cumprod(alphas.numpy()))
    ac_prev = torch.cat([torch.ones(1), ac[:-1]])
    post_logvar = torch.log(torch.clamp(betas * (1 - ac_prev) / (1 - ac), min=1e-20))
    coef1 = betas * torch.sqrt(ac_prev) / (1 - ac)
    coef2 = (1 - ac_prev) * torch.sqrt(alphas) / (1 - ac)

    device = z_lq.device
    x = _start(shape, generator, device, x_init)
    for i in range(n):
        idx = n - 1 - i
        eps = apply_model(x, _timestep(timesteps[idx], x.shape[0], device), context, z_lq)
        x0 = torch.clamp((x - torch.sqrt(1 - ac[idx]) * eps) / torch.sqrt(ac[idx]), -1.0, 1.0)
        x = coef1[idx] * x0 + coef2[idx] * x
        if idx != 0:
            noise = (noises[i].to(device) if noises is not None
                     else torch.randn(x.shape, generator=generator, device=device))
            x = x + torch.exp(0.5 * post_logvar[idx]) * noise
    return x


def gaussian_tile_weights(tile_size: int, sigma_frac: float = 0.25) -> np.ndarray:
    """Gaussian blending weights for tiled latent sampling (the reference
    ddpm.py:2890 gaussian_weights)."""
    ax = np.arange(tile_size) - (tile_size - 1) / 2.0
    sig = tile_size * sigma_frac
    g = np.exp(-(ax ** 2) / (2 * sig ** 2))
    w = np.outer(g, g)
    return (w / w.max()).astype(np.float32)


@torch.no_grad()
def tiled_sample(sample_fn: Callable, z_lq: torch.Tensor, tile: int, overlap: int,
                 latent_channels: int = 4, data_parallel: bool = False):
    """Canvas-tiled sampling over NCHW latents: run ``sample_fn`` on
    overlapping z_lq tiles one after another and blend them with Gaussian
    weights (the reference p_sample_loop_canvas :2908-2981)."""
    if data_parallel:
        raise NotImplementedError("tiles in parallel across devices are not ported yet "
                                  "(ROADMAP.md, queue 1: parallelism)")
    b, _, h, w = z_lq.shape
    stride = tile - overlap
    weights = torch.from_numpy(gaussian_tile_weights(tile)).to(z_lq.device)[None, None]
    canvas = torch.zeros((b, latent_channels, h, w), device=z_lq.device)
    acc = torch.zeros((b, 1, h, w), device=z_lq.device)
    ys = list(range(0, max(h - tile, 0) + 1, stride)) or [0]
    xs = list(range(0, max(w - tile, 0) + 1, stride)) or [0]
    if ys[-1] + tile < h:
        ys.append(h - tile)
    if xs[-1] + tile < w:
        xs.append(w - tile)
    for y0 in ys:
        for x0 in xs:
            out = sample_fn(z_lq[:, :, y0:y0 + tile, x0:x0 + tile])
            canvas[:, :, y0:y0 + tile, x0:x0 + tile] += out * weights
            acc[:, :, y0:y0 + tile, x0:x0 + tile] += weights
    return canvas / torch.clamp(acc, min=1e-8)
