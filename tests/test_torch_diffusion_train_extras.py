"""The port's StableSR-SSL train step against ssl_tpu's (fp32, CPU):
gradient accumulation (``optax.MultiSteps`` with 2 mini-steps), the decode
skipped when nothing reads the decoded image, and the training preview.

Setup and tolerances as in tests/test_torch_diffusion_train.py; the preview's
images rtol 1e-4 with an atol of 1e-5 of the reference's largest value, as
for one model call (tests/test_torch_diffusion.py)."""

import jax
import numpy as np
import torch

from torch_diffusion_cases import close
from torch_diffusion_train_cases import (batch, capture_grads, check_logs, check_weights, flat,
                                         jax_draws, jax_preview_draws, pair, torch_batch)


def test_accumulation_matches_jax():
    """accumulate 2: the first mini-step leaves the weights exactly as they
    were (the EMA still moves toward them), the second applies the mean of
    both gradients, with AdamW's step count 1."""
    jm, jstate, tm, state = pair("eps", accumulate=2)
    b0, b1 = batch(0), batch(1)
    start = {k: v.clone() for k, v in flat(state.params).items()}
    start_jax = flat(jstate.params)
    grads = capture_grads(state)

    draws = jax_draws(jm, jstate)
    jstate, jlogs = jm.train_step(jstate, b0)
    state, tlogs = tm.train_step(state, torch_batch(b0), draws)
    check_logs(tlogs, jlogs)
    assert state.mini_step == 1 and not grads
    for k, v in flat(state.params).items():
        assert torch.equal(v, start[k]), k
    for k, v in flat(jstate.params).items():
        assert torch.equal(v, start_jax[k]), k
    ema_jax = flat(jstate.ema_params)
    for k, v in flat(state.ema_params).items():     # 0.1 w + 0.9 w
        np.testing.assert_allclose(v.numpy(), ema_jax[k].numpy(), rtol=0, atol=1e-6, err_msg=k)

    draws = jax_draws(jm, jstate)
    jstate, jlogs = jm.train_step(jstate, b1)
    state, tlogs = tm.train_step(state, torch_batch(b1), draws)
    check_logs(tlogs, jlogs)
    assert state.step == int(jstate.step) == 2 and state.mini_step == 0 and grads
    assert state.opt.state[state.params["null_context"]]["step"] == 1
    check_weights(flat(state.params), flat(jstate.params), grads)
    check_weights(flat(state.ema_params), flat(jstate.ema_params), grads)


def test_decode_skipped_without_pixel_loss_or_ssl():
    """pixel_weight 0 and no gt_mask: nothing reads the decoded image, so
    neither step decodes, and the logs are l_simple and l_total."""
    jm, jstate, tm, state = pair("eps", pixel_weight=0.0)
    b = {k: v for k, v in batch().items() if k != "gt_mask"}
    decodes = []
    decode = tm.decode
    tm.decode = lambda *a: (decodes.append(1), decode(*a))[1]
    grads = capture_grads(state)
    draws = jax_draws(jm, jstate)
    jstate, jlogs = jm.train_step(jstate, b)
    state, tlogs = tm.train_step(state, torch_batch(b), draws)
    assert not decodes and sorted(tlogs) == ["l_simple", "l_total"]
    check_logs(tlogs, jlogs)
    check_weights(flat(state.params), flat(jstate.params), grads)


def test_preview_matches_jax():
    """inputs, gt, the VAE reconstruction and the one-step x0 at t = T/2,
    from the EMA weights, with the JAX preview's fixed draws."""
    jm, jstate, tm, state = pair("v")
    b = batch()
    ref = jax.tree_util.tree_map(np.asarray, jm.preview(jstate, b))
    got = tm.preview(state, torch_batch(b), jax_preview_draws())
    assert sorted(got) == sorted(ref) == ["gt", "inputs", "pred_x0", "reconstruction"]
    for k in ref:
        assert got[k].shape == (2, 3, 32, 32)
        close(got[k].numpy().transpose(0, 2, 3, 1), ref[k])
    assert float(np.std(ref["pred_x0"])) > 1e-2
    again = tm.preview(state, torch_batch(b))            # its own seeded draws repeat
    assert torch.equal(again["pred_x0"], tm.preview(state, torch_batch(b))["pred_x0"])
