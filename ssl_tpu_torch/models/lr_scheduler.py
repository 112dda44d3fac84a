"""LR schedules as plain functions of the step.

Counterpart of ``ssl_tpu/models/lr_scheduler.py`` (reference
models/lr_scheduler.py: MultiStepRestartLR :6, CosineAnnealingRestartLR :57,
plus plain MultiStepLR).  A schedule maps the number of optimizer updates
taken so far to the learning rate of the next one; the recipes write it into
the optimizer's param groups before each step."""

from __future__ import annotations

import math

import numpy as np


def multi_step_lr(base_lr: float, milestones, gamma: float = 0.5,
                  restarts=(), restart_weights=()):
    """lr *= gamma at each milestone; at each restart the decay resets and lr
    is scaled by the restart weight (reference MultiStepRestartLR)."""
    milestones = sorted(milestones)
    restarts = list(restarts)
    weights = list(restart_weights) if restart_weights else [1.0] * len(restarts)

    def schedule(step: int) -> float:
        w, last_restart = 1.0, 0
        for r, rw in zip(restarts, weights):
            if step >= r:
                w, last_restart = rw, r
        decay = sum(1 for m in milestones if last_restart + m <= step)
        return base_lr * w * (gamma ** decay)
    return schedule


def cosine_annealing_restart_lr(base_lr: float, periods, restart_weights=(1.0,),
                                eta_min: float = 0.0):
    """Cosine annealing with warm restarts (reference lr_scheduler.py:57-107):
    within period i (weight w_i) lr = eta_min + w_i (base_lr - eta_min)
    (1 + cos(pi t / T_i)) / 2; past the last period its cosine continues."""
    periods = [int(p) for p in periods]
    cumulative = np.cumsum(periods).tolist()
    starts = [0] + cumulative
    weights = list(restart_weights) + [restart_weights[-1]] * (len(periods) - len(restart_weights))

    def schedule(step: int) -> float:
        idx = min(sum(1 for c in cumulative if step >= c), len(periods) - 1)
        frac = (step - starts[idx]) / max(periods[idx], 1)
        return eta_min + weights[idx] * 0.5 * (base_lr - eta_min) * (1 + math.cos(math.pi * frac))
    return schedule


def build_schedule(train_opt: dict, base_lr: float):
    sched = dict(train_opt.get("scheduler") or {})
    stype = sched.pop("type", None)
    warmup = train_opt.get("warmup_iter", -1)
    if stype in ("MultiStepLR", "MultiStepRestartLR"):
        base = multi_step_lr(base_lr, sched.get("milestones", []), sched.get("gamma", 0.5),
                             sched.get("restarts", ()), sched.get("restart_weights", ()))
    elif stype == "CosineAnnealingRestartLR":
        base = cosine_annealing_restart_lr(base_lr, sched["periods"],
                                           sched.get("restart_weights", (1.0,)),
                                           sched.get("eta_min", 0.0))
    elif stype is None:
        def base(step):
            return base_lr
    else:
        raise NotImplementedError(f"Scheduler {stype} is not implemented yet.")
    if warmup and warmup > 0:
        def with_warmup(step):
            return base(step) * min(1.0, (step + 1) / warmup)
        return with_warmup
    return base
