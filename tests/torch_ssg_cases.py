"""Inputs of the port's SSG tests, made with numpy from a seed.

Imports neither JAX nor ssl_tpu, so that the card-only tests
(``test_torch_cuda.py``) can use it on a machine without JAX.

The data are smooth images and a noisy copy (noise 0.1), the regime where
the similarity rows are far from 0; each seed was picked so that no masked
pixel has an offset with |x - y| below 1e-5 of max(x, y): the L1 subgradient
sign(x - y) is discontinuous there, and two implementations' float rounding
(1e-6 to 1e-5 relative in q, see MAP_RTOL) could pick different sides."""

import numpy as np

# name: (b, h, search, window, sigma, seed, mask density)
CASES = {
    "small": (2, 20, 9, 5, 0.1, 47, 0.3),
    "shipped": (1, 32, 25, 9, 0.004, 2, 0.3),
}

# rtol of the (b, h, w) maps.  S_d = box9(C2) + rect(D - C2) cancels a box of
# C2 of ~70 at these images, so S carries float32 rounding of ~1e-5 absolute,
# and q = exp(-S / (c window^2 sigma)) turns that into a relative error of
# ~1e-5 / (c window^2 sigma): ~1e-6 at sigma 0.1, ~1e-5 at the shipped 0.004.
MAP_RTOL = {"small": 1e-5, "shipped": 1e-4}


def grad_atol(ref) -> float:
    """1e-7, or 1e-6 of the gradient's largest value: d_sr sums terms
    inv g_d - inv^2 T that cancel, so the maps' relative error shows up on the
    gradient's own scale."""
    return max(1e-7, 1e-6 * float(np.abs(ref).max()))


def smooth_pair(b, h, seed, density):
    """(sr, gt, mask) as float32 (b, 3, h, h), (b, 3, h, h), (b, h, h)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:h] / h
    base = np.stack([np.sin(6 * yy) + np.cos(5 * xx), yy * xx, np.cos(8 * (yy + xx))]) * 0.3 + 0.5
    gt = np.stack([base * (0.9 + 0.1 * i) for i in range(b)]).astype(np.float32)
    sr = (gt + rng.randn(b, 3, h, h) * 0.1).astype(np.float32)
    mask = (rng.rand(b, h, h) < density).astype(np.float32)
    return sr, gt, mask


def case_inputs(name):
    """(sr, gt, mask, search, window, sigma) of a named case."""
    b, h, search, window, sigma, seed, density = CASES[name]
    return (*smooth_pair(b, h, seed, density), search, window, sigma)
