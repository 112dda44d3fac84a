"""Blur-kernel zoo for blind-SR degradation synthesis (numpy/scipy, host side).

Counterpart of the kernel synthesis of ``ssl_tpu/data/degradations.py``
(reference data/degradations.py: iso/aniso generalized Gaussian and plateau
kernels :84-175, randomized samplers :176-388, sinc lowpass :389), copied so
that the port imports nothing of ``ssl_tpu``.  The draws go through the
given ``rng`` (``np.random`` when None) in the same order, so one seed gives
the same kernels in both packages.  The numpy noise models of the host-side
degrader wait for it (ROADMAP.md)."""

from __future__ import annotations

import math

import numpy as np
from scipy import special


# ---------------------------------------------------------------------------
# Gaussian / generalized-Gaussian / plateau kernel families
# ---------------------------------------------------------------------------

def _mesh_grid(kernel_size: int):
    ax = np.arange(-(kernel_size - 1) / 2.0, (kernel_size - 1) / 2.0 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    xy = np.stack([xx, yy], axis=-1)[..., None]  # (k,k,2,1)
    return xy, xx, yy


def _sigma_matrix(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    d = np.array([[sig_x ** 2, 0.0], [0.0, sig_y ** 2]])
    u = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def bivariate_gaussian(kernel_size, sig_x, sig_y=None, theta=0.0, grid=None, isotropic=True):
    if grid is None:
        grid, _, _ = _mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0.0], [0.0, sig_x ** 2]])
    else:
        sigma = _sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    expo = -0.5 * np.squeeze(np.swapaxes(grid, -2, -1) @ inv @ grid)
    kernel = np.exp(expo)
    return kernel / kernel.sum()


def bivariate_generalized_gaussian(kernel_size, sig_x, sig_y=None, theta=0.0, beta=1.0,
                                   grid=None, isotropic=True):
    if grid is None:
        grid, _, _ = _mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0.0], [0.0, sig_x ** 2]])
    else:
        sigma = _sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    quad = np.squeeze(np.swapaxes(grid, -2, -1) @ inv @ grid)
    kernel = np.exp(-0.5 * np.power(quad, beta))
    return kernel / kernel.sum()


def bivariate_plateau(kernel_size, sig_x, sig_y=None, theta=0.0, beta=1.0,
                      grid=None, isotropic=True):
    if grid is None:
        grid, _, _ = _mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0.0], [0.0, sig_x ** 2]])
    else:
        sigma = _sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    quad = np.squeeze(np.swapaxes(grid, -2, -1) @ inv @ grid)
    kernel = 1.0 / (np.power(quad, beta) + 1.0)
    return kernel / kernel.sum()


def circular_lowpass_kernel(cutoff: float, kernel_size: int, pad_to: int = 0) -> np.ndarray:
    """2-D sinc filter (reference degradations.py:389-416)."""
    if kernel_size % 2 != 1:
        raise ValueError(f"kernel_size must be odd, got {kernel_size}")
    with np.errstate(invalid="ignore", divide="ignore"):
        kernel = np.fromfunction(
            lambda x, y: cutoff * special.j1(
                cutoff * np.sqrt((x - (kernel_size - 1) / 2) ** 2 + (y - (kernel_size - 1) / 2) ** 2))
            / (2 * np.pi * np.sqrt((x - (kernel_size - 1) / 2) ** 2 + (y - (kernel_size - 1) / 2) ** 2)),
            [kernel_size, kernel_size])
    kernel[(kernel_size - 1) // 2, (kernel_size - 1) // 2] = cutoff ** 2 / (4 * np.pi)
    kernel = kernel / np.sum(kernel)
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((pad, pad), (pad, pad)))
    return kernel


# ---------------------------------------------------------------------------
# Random samplers
# ---------------------------------------------------------------------------

def random_bivariate_gaussian(kernel_size, sigma_x_range, sigma_y_range=None,
                              rotation_range=(-math.pi, math.pi), noise_range=None,
                              isotropic=True, rng=None):
    rng = rng or np.random
    sig_x = rng.uniform(*sigma_x_range)
    if isotropic:
        sig_y, theta = sig_x, 0.0
    else:
        sig_y = rng.uniform(*sigma_y_range)
        theta = rng.uniform(*rotation_range)
    kernel = bivariate_gaussian(kernel_size, sig_x, sig_y, theta, isotropic=isotropic)
    if noise_range is not None:
        noise = rng.uniform(noise_range[0], noise_range[1], size=kernel.shape)
        kernel = kernel * noise
    return kernel / kernel.sum()


def random_bivariate_generalized_gaussian(kernel_size, sigma_x_range, sigma_y_range=None,
                                          rotation_range=(-math.pi, math.pi),
                                          beta_range=(0.5, 4.0), noise_range=None,
                                          isotropic=True, rng=None):
    rng = rng or np.random
    sig_x = rng.uniform(*sigma_x_range)
    if isotropic:
        sig_y, theta = sig_x, 0.0
    else:
        sig_y = rng.uniform(*sigma_y_range)
        theta = rng.uniform(*rotation_range)
    # beta sampled either side of 1 (reference behavior)
    if rng.uniform() < 0.5:
        beta = rng.uniform(beta_range[0], 1.0)
    else:
        beta = rng.uniform(1.0, beta_range[1])
    kernel = bivariate_generalized_gaussian(kernel_size, sig_x, sig_y, theta, beta, isotropic=isotropic)
    if noise_range is not None:
        noise = rng.uniform(noise_range[0], noise_range[1], size=kernel.shape)
        kernel = kernel * noise
    return kernel / kernel.sum()


def random_bivariate_plateau(kernel_size, sigma_x_range, sigma_y_range=None,
                             rotation_range=(-math.pi, math.pi), beta_range=(1.0, 2.0),
                             noise_range=None, isotropic=True, rng=None):
    rng = rng or np.random
    sig_x = rng.uniform(*sigma_x_range)
    if isotropic:
        sig_y, theta = sig_x, 0.0
    else:
        sig_y = rng.uniform(*sigma_y_range)
        theta = rng.uniform(*rotation_range)
    if rng.uniform() < 0.5:
        beta = rng.uniform(beta_range[0], 1.0)
    else:
        beta = rng.uniform(1.0, beta_range[1])
    kernel = bivariate_plateau(kernel_size, sig_x, sig_y, theta, beta, isotropic=isotropic)
    if noise_range is not None:
        noise = rng.uniform(noise_range[0], noise_range[1], size=kernel.shape)
        kernel = kernel * noise
    return kernel / kernel.sum()


def random_mixed_kernels(kernel_list, kernel_prob, kernel_size,
                         sigma_x_range=(0.6, 5), sigma_y_range=(0.6, 5),
                         rotation_range=(-math.pi, math.pi),
                         betag_range=(0.5, 8), betap_range=(0.5, 8),
                         noise_range=None, rng=None):
    """Sample one kernel from the 6-family mixture (reference :176-257)."""
    rng = rng or np.random
    kernel_type = rng.choice(kernel_list, p=kernel_prob)
    if kernel_type == "iso":
        return random_bivariate_gaussian(kernel_size, sigma_x_range, noise_range=noise_range,
                                         isotropic=True, rng=rng)
    if kernel_type == "aniso":
        return random_bivariate_gaussian(kernel_size, sigma_x_range, sigma_y_range,
                                         rotation_range, noise_range, isotropic=False, rng=rng)
    if kernel_type == "generalized_iso":
        return random_bivariate_generalized_gaussian(kernel_size, sigma_x_range,
                                                     beta_range=betag_range,
                                                     noise_range=noise_range, isotropic=True, rng=rng)
    if kernel_type == "generalized_aniso":
        return random_bivariate_generalized_gaussian(kernel_size, sigma_x_range, sigma_y_range,
                                                     rotation_range, betag_range, noise_range,
                                                     isotropic=False, rng=rng)
    if kernel_type == "plateau_iso":
        return random_bivariate_plateau(kernel_size, sigma_x_range, beta_range=betap_range,
                                        noise_range=None, isotropic=True, rng=rng)
    if kernel_type == "plateau_aniso":
        return random_bivariate_plateau(kernel_size, sigma_x_range, sigma_y_range,
                                        rotation_range, betap_range, None, isotropic=False, rng=rng)
    raise ValueError(f"unknown kernel type {kernel_type}")
