"""Shared pieces of the host-degrader parity tests
(tests/test_torch_realesr_degradation.py, test_torch_diffusion_data.py,
test_torch_diffusion_train_cli.py): a deterministic Poisson draw injected
into both packages' plans, the one-uint8-level hold of the LQ, and seeded
blur kernels.

The LQ hold: both packages end on uint8 levels, and the float32 filters,
resizes and 8 x 8 DCTs sum in other orders, so a value (or a JPEG
coefficient) within rounding of a half-integer may go the other way; at
most ``LEVEL_SHARE`` of the values may differ, by one level."""

import random

import numpy as np

from ssl_tpu.data.realesrgan_dataset import _KernelSynth

LEVEL_SHARE = 1e-3


def det_poisson(lam):
    """tests/test_degradation_parity.py's deterministic 'Poisson' draw."""
    return np.floor(lam) + (lam - np.floor(lam) > 0.5)


def with_det_poisson(degrader):
    """Make every plan ``degrader`` draws use ``det_poisson`` (both packages'
    plans have the ``poisson`` seam; the Gaussian fields stay drawn)."""
    draw = degrader.draw_plan

    def plan(b):
        p = draw(b)
        for stage in ("noise1", "noise2"):
            if stage in p:
                p[stage]["poisson"] = det_poisson
        return p
    degrader.draw_plan = plan
    return degrader


def check_levels(got, want):
    """At most one uint8 level apart, on at most LEVEL_SHARE of the values."""
    levels = np.abs(np.round(np.asarray(got) * 255) - np.round(np.asarray(want) * 255))
    assert got.shape == want.shape
    assert levels.max() <= 1 and (levels > 0).mean() <= LEVEL_SHARE, \
        (levels.max(), (levels > 0).mean())


def kernels(b, seed):
    """b items' (kernel1, kernel2, sinc_kernel) from the loader's synthesis."""
    np.random.seed(seed)
    random.seed(seed)
    synth = _KernelSynth({})
    ks = [synth.sample() for _ in range(b)]
    return [np.stack([k[i] for k in ks]).astype(np.float32) for i in range(3)]
