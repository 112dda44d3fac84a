"""The port's optimizers (``models/base_model.py::build_optimizer``) and
its cosine schedule with restarts against the JAX package's optax
transforms: 10 updates of the same parameters with the same gradients, the
learning rate from each package's schedule (a step schedule, and the cosine
with restarts).

Tolerance: rtol 1e-5 and atol 1e-7 on the parameters (O(1)) after each
update: the two sides order their float32 operations differently (torch's
Adam divides by sqrt(v) / sqrt(bc2) + eps, optax by sqrt(v / bc2) + eps;
JAX evaluates the cosine in float32), so ten updates of lr 1e-2 agree to a
few float32 ulps of the parameters."""

import copy

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssl_tpu.models.base_model import build_optimizer as jax_build_optimizer
from ssl_tpu.models.lr_scheduler import build_schedule as jax_build_schedule
from ssl_tpu_torch.models.base_model import build_optimizer, optimizer_step
from ssl_tpu_torch.models.lr_scheduler import build_schedule

OPTIMIZERS = {
    "Adam": {"type": "Adam", "lr": 1e-2, "betas": [0.9, 0.99]},
    "Adam_wd": {"type": "Adam", "lr": 1e-2, "weight_decay": 0.1},
    "AdamW": {"type": "AdamW", "lr": 1e-2, "betas": [0.9, 0.99], "weight_decay": 0.05},
    "SGD": {"type": "SGD", "lr": 1e-2},
    "SGD_momentum": {"type": "SGD", "lr": 1e-2, "momentum": 0.9, "weight_decay": 0.1},
    "RMSprop": {"type": "RMSprop", "lr": 1e-2, "weight_decay": 0.1},
    "Adamax": {"type": "Adamax", "lr": 1e-2, "betas": [0.8, 0.95]},
}
SCHEDULES = {
    "multistep": {"scheduler": {"type": "MultiStepLR", "milestones": [4, 7], "gamma": 0.5}},
    "cosine": {"scheduler": {"type": "CosineAnnealingRestartLR", "periods": [4, 6],
                             "restart_weights": [1.0, 0.5], "eta_min": 1e-4}},
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_ten_updates_match_optax(name, schedule):
    optim_opt = OPTIMIZERS[name]
    rng = np.random.RandomState(sum(map(ord, name + schedule)))
    params = {"w": rng.randn(6, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    # gradients of several scales, some tiny (where eps placement matters)
    grads = [{k: (rng.randn(*v.shape) * 10.0 ** rng.randint(-5, 1)).astype(np.float32)
              for k, v in params.items()} for _ in range(10)]

    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ("w", "b")]
    tsched = build_schedule(SCHEDULES[schedule], optim_opt["lr"])
    topt = build_optimizer(copy.deepcopy(optim_opt), tparams, tsched)

    jsched = jax_build_schedule(SCHEDULES[schedule], optim_opt["lr"])
    tx = jax_build_optimizer(copy.deepcopy(optim_opt), jsched)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)

    for step, g in enumerate(grads):
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, k in zip(tparams, ("w", "b")):
            p.grad = torch.from_numpy(g[k].copy())
        optimizer_step(topt, tsched(step))
        for p, k in zip(tparams, ("w", "b")):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name} {schedule} step {step} {k}")


def test_rmsprop_keeps_eps_inside_the_root():
    """Where nu is tiny the placement shows: optax's 1 / sqrt(nu + eps) step,
    not torch's 1 / (sqrt(nu) + eps)."""
    p = torch.nn.Parameter(torch.zeros(1))
    opt = build_optimizer({"type": "RMSprop"}, [p], lambda s: 1.0)
    p.grad = torch.full((1,), 1e-4)
    opt.step()
    nu = 0.1 * 1e-8
    assert float(p.detach()) == pytest.approx(-1e-4 / np.sqrt(nu + 1e-8), rel=1e-5)


def test_optimizer_states_reload():
    """Every optimizer's state dict loads into a fresh one of its type, so a
    training state resumes with it."""
    for name, optim_opt in OPTIMIZERS.items():
        p = torch.nn.Parameter(torch.ones(3))
        opt = build_optimizer(dict(optim_opt), [p], lambda s: 0.1)
        p.grad = torch.full((3,), 0.5)
        optimizer_step(opt, 0.1)
        q = torch.nn.Parameter(p.detach().clone())
        fresh = build_optimizer(dict(optim_opt), [q], lambda s: 0.1)
        fresh.load_state_dict(copy.deepcopy(opt.state_dict()))   # as read back from a file
        p.grad, q.grad = torch.full((3,), -0.25), torch.full((3,), -0.25)
        optimizer_step(opt, 0.1)
        optimizer_step(fresh, 0.1)
        assert torch.equal(p, q), name
