"""The port's StableSR-SSL train step against ssl_tpu's (fp32, CPU), for the
eps, v and x0 parameterizations, and with a strategy of the zoo as the SSL
term: a dense tile one (areaarea) and a masked one (the CUDA op's epilogue,
whose rows the port's areaarea_mask_nonlocal shares; that key is held
against JAX's through ssl_loss in tests/test_torch_simself_strategies.py):
the logs, and the weights and their EMA after one step (accumulate 1).

Configs, seeded non-zero weights and the JAX step's draws (recomputed from
``state.rng`` as the JAX step splits it, and handed to the port):
tests/torch_diffusion_train_cases.py.  The flash switch is on in both; on the
CPU both take the plain attention.

Tolerances.  Logs: rtol 1e-4 (float32 sums in other orders).  Weights: an
atol of lr/5.  AdamW's first update moves each weight by
lr * g / (|g| + eps) + lr * wd * w, about lr * sign(g), so a wrong update
shows as an lr-sized error; but where the gradient is at the level of its own
rounding (mathematically 0, as for a bias added before a GroupNorm whose
groups hold one channel, or below 1e-5 of the largest gradient) the two
frameworks' g / (|g| + eps) are rounding noise of either sign, and such
elements may differ by up to 2 lr.  ``check_weights`` allows that only there,
and only for at most 5% of the elements (1.43% sit there with the eps
parameterization, most of them in the mathematically-zero gradients).  The
EMA after one step is 0.1 * w0 + 0.9 * w1, within the same bounds."""

import jax
import pytest
import torch

from torch_diffusion_train_cases import (LR, batch, capture_grads, check_logs, check_weights,
                                         flat, jax_draws, pair, torch_batch)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread (the suite runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("parameterization,strategy", [
    ("eps", ""), ("v", ""), ("x0", ""), ("eps", "areaarea"),
    ("eps", "areaarea_mask_nonlocal_cuda_v1")],
    ids=["eps", "v", "x0", "areaarea", "areaarea_mask_nonlocal_cuda_v1"])
def test_train_step_matches_jax(parameterization, strategy):
    jm, jstate, tm, state = pair(parameterization, strategy=strategy)
    b = batch()
    draws = jax_draws(jm, jstate)
    before = {k: v.clone() for k, v in flat(state.params).items()}
    grads = capture_grads(state)
    jstate, jlogs = jm.train_step(jstate, b)
    state, tlogs = tm.train_step(state, torch_batch(b), draws)
    assert state.step == int(jstate.step) == 1 and state.mini_step == 0
    assert sorted(tlogs) == ["l_pixel", "l_selfsim", "l_selfsim_kl", "l_simple", "l_total"]
    check_logs(tlogs, jlogs)
    got, ref = flat(state.params), flat(jstate.params)
    check_weights(got, ref, grads)
    check_weights(flat(state.ema_params), flat(jstate.ema_params), grads, scale=0.9)
    # the step moved almost every weight by about lr
    moved = sum(int(((got[k] - before[k]).abs() > LR / 2).sum()) for k in got)
    assert moved > 0.9 * sum(v.numel() for v in got.values())
    assert float(jax.numpy.abs(jstate.opt_state[0].count)) == 1
