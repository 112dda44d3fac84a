"""Diffusion schedules and forward-process math.

Counterpart of ``ssl_tpu/diffusion/schedules.py``.  The schedule is computed
in float64 numpy and stored as float32 tensors, as the JAX package does.  It
stays on the CPU: the samplers read it at Python-int timesteps,
and the forward-process helpers move the entries they index to the device
of the timesteps."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int, linear_start=1e-4,
                       linear_end=2e-2, cosine_s=8e-3) -> np.ndarray:
    if schedule == "linear":
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas


class DiffusionSchedule(NamedTuple):
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def build_schedule_arrays(betas: np.ndarray, v_posterior: float = 0.0) -> DiffusionSchedule:
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = ((1 - v_posterior) * betas * (1 - alphas_cumprod_prev) /
                          (1 - alphas_cumprod) + v_posterior * betas)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1 / alphas_cumprod - 1)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(np.log(np.maximum(posterior_variance, 1e-20))),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1 - alphas_cumprod)),
        posterior_mean_coef2=f32((1 - alphas_cumprod_prev) * np.sqrt(alphas) /
                                 (1 - alphas_cumprod)),
    )


def _extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    return a.to(t.device)[t].reshape(t.shape[0], *([1] * (ndim - 1)))


def q_sample(sched: DiffusionSchedule, x0, t, noise):
    return (_extract(sched.sqrt_alphas_cumprod, t, x0.ndim) * x0 +
            _extract(sched.sqrt_one_minus_alphas_cumprod, t, x0.ndim) * noise)


def predict_start_from_noise(sched: DiffusionSchedule, x_t, t, noise):
    return (_extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t -
            _extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise)


def get_v(sched: DiffusionSchedule, x0, noise, t):
    return (_extract(sched.sqrt_alphas_cumprod, t, x0.ndim) * noise -
            _extract(sched.sqrt_one_minus_alphas_cumprod, t, x0.ndim) * x0)


def predict_start_from_v(sched: DiffusionSchedule, x_t, t, v):
    return (_extract(sched.sqrt_alphas_cumprod, t, x_t.ndim) * x_t -
            _extract(sched.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * v)


def q_posterior(sched: DiffusionSchedule, x0, x_t, t):
    mean = (_extract(sched.posterior_mean_coef1, t, x_t.ndim) * x0 +
            _extract(sched.posterior_mean_coef2, t, x_t.ndim) * x_t)
    var = _extract(sched.posterior_variance, t, x_t.ndim)
    logvar = _extract(sched.posterior_log_variance_clipped, t, x_t.ndim)
    return mean, var, logvar


def space_timesteps(num_timesteps: int, section_counts) -> list[int]:
    """Evenly spaced timestep subset (ssl_tpu/diffusion/schedules.py::space_timesteps)."""
    if isinstance(section_counts, int):
        section_counts = [section_counts]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        stride = (size - 1) / max(section_count - 1, 1)
        cur = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur))
            cur += stride
        start_idx += size
    return sorted(set(all_steps))
