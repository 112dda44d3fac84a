"""The port's SPSR-SSL train step against ssl_tpu's, from identical weights
and batches (fp32, CPU): three steps through the ``net_d_init_iters`` gate
and ``Branch_pretrain``, with both D's and one Adam over them.  Its own file:
the JAX step of the 25-RRDB generator takes minutes to compile on a
CPU.  Sizes, helpers and tolerances: tests/torch_recipe_cases.py."""

import pytest
import torch

from torch_recipe_cases import check_logs, check_nets, grad_watch, losses, pair, step, train_opt


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread (the suite runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_spsr_gate_and_branch_pretrain_match_jax():
    """net_d_init_iters 1: at step 1 G and its Adam moments stay as they were
    (nothing steps), while both D's move; Branch_init_iters 2: at step 2
    only the fusion parameters (f_*) move; at step 3 all of G does.  Each
    step matches the JAX step."""
    jmodel, jstate, tmodel, tstate = pair(train_opt(
        "SPSRSSL", net_d_init_iters=1, Branch_pretrain=1, Branch_init_iters=2))
    noisy = grad_watch(tstate)
    before = {k: v.clone() for k, v in tstate.net_g.state_dict().items()}
    d_before = {k: v.clone() for k, v in tstate.nets["net_d_grad"].state_dict().items()}
    for i in range(3):
        jstate, jlogs, tstate, tlogs = step(jmodel, jstate, tmodel, tstate, i)
        check_logs(jlogs, tlogs, losses("SPSRSSL"))
        check_nets(jstate, tstate, noisy)
        now = tstate.net_g.state_dict()
        moved = {k for k, v in now.items() if not torch.equal(v, before[k])}
        if i == 0:
            assert not moved and not tstate.opt_g.state_dict()["state"]
            assert not all(torch.equal(v, d_before[k])
                           for k, v in tstate.nets["net_d_grad"].state_dict().items())
        elif i == 1:
            assert moved and all(k.startswith("f_") for k in moved)
            assert len(tstate.opt_g.state_dict()["state"]) == len(before)
        else:
            assert any(not k.startswith("f_") for k in moved)
        before = {k: v.clone() for k, v in now.items()}
