"""Tiny diffusion configs and seeded weights shared by the port's diffusion
tests (the configs of tests/test_diffusion.py, with attention at every level
and the flash switch on, which takes the einsum path on the CPU in both
packages).

Weights are drawn with numpy from a seed at the shapes of the flax init
(``jax.eval_shape``, which skips the slow eager init): kernels N(0, 1/fan_in),
norm scales 1 + N(0, 0.05²), biases N(0, 0.05²).  Nothing is left at 0: at
the JAX package's init the zero-initialised output layers would make every
attention's contribution, and the UNet's output, exactly 0."""

import jax
import numpy as np
import torch

UNET = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(1, 2),
            num_heads=4, num_head_channels=-1, context_dim=32, semb_channels=32,
            use_flash_attention=True)
STRUCT = dict(model_channels=32, channel_mult=(1, 2), out_channels=32, num_res_blocks=1,
              num_heads=4, use_flash_attention=True)
VAE = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, embed_dim=4, use_flash_attention=True)
CFG = dict(timesteps=20, context_dim=32, context_len=4)


def seeded_params(module, *args, seed=0):
    """numpy params tree for the flax ``module`` applied to ``args``."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.05 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def close(got, ref, rtol=1e-4):
    """rtol 1e-4 with an atol of 1e-5 of the reference's largest value."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-5 * np.abs(ref).max())
