"""The port's train steps of the six bicubic GAN-SSL recipes (and the plain
BebyGAN) against ssl_tpu's, from identical weights and batches (fp32, CPU):
the losses, G, its EMA, the D's and their statistics after each of two
steps; RankSRGAN's rank term, which gives G no gradient, and its
``pretrain_network_r``.  SPSR's step is
held in tests/test_torch_recipe_spsr_step.py.  Sizes, helpers and
tolerances: tests/torch_recipe_cases.py."""

import numpy as np
import pytest
import torch

from ssl_tpu_torch.models import build_model
from torch_recipe_cases import (check_logs, check_nets, grad_watch, losses, nchw, pair, step,
                                batch, train_opt)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread (the suite runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("recipe", ["LDLSSL", "BebyGANSSL", "BebyGAN", "SwinIRGANSSL",
                                    "ELANGANSSL", "RankSRGANPISSL"])
def test_recipe_two_steps_match_jax(recipe):
    jmodel, jstate, tmodel, tstate = pair(train_opt(recipe))
    noisy = grad_watch(tstate)
    ranker = None
    if recipe == "RankSRGANPISSL":
        ranker = {k: v.clone() for k, v in tstate.extra["net_r"].state_dict().items()}
    for i in range(2):
        jstate, jlogs, tstate, tlogs = step(jmodel, jstate, tmodel, tstate, i)
        assert set(losses(recipe)) <= set(tlogs)
        if recipe == "BebyGAN":
            assert "l_selfsim" not in tlogs
        check_logs(jlogs, tlogs, losses(recipe))
        check_nets(jstate, tstate, noisy)
    if ranker is not None:        # frozen, eval mode, running statistics untouched
        net_r = tstate.extra["net_r"]
        assert not net_r.training and not any(p.requires_grad for p in net_r.parameters())
        assert all(torch.equal(v, ranker[k]) for k, v in net_r.state_dict().items())


def test_ranksrgan_rank_term_gives_g_no_gradient():
    """The same step with the rank term's weight 0.03 and 0: l_g_rank is
    logged and in l_g_total, and G, its EMA and D come out bit for bit the
    same."""
    states = {}
    for weight in (0.03, 0.0):
        model = build_model(train_opt("RankSRGANPISSL", rank_opt={"loss_weight": weight,
                                                                    "R_bias": 0.0}),
                            device="cpu")
        state = model.init_state(seed=0)
        state, logs = model.train_step(state, {k: nchw(v) for k, v in batch(0).items()})
        states[weight] = (state, {k: float(v) for k, v in logs.items()})
    (a, logs_a), (b, logs_b) = states[0.03], states[0.0]
    assert logs_a["l_g_rank"] > 0 and "l_g_rank" not in logs_b
    np.testing.assert_allclose(logs_a["l_g_total"] - logs_a["l_g_rank"], logs_b["l_g_total"],
                               rtol=1e-6)
    for net in ("net_g", "net_g_ema", "net_d"):
        sa, sb = getattr(a, net).state_dict(), getattr(b, net).state_dict()
        assert all(torch.equal(v, sb[k]) for k, v in sa.items()), net


def test_ranksrgan_pretrain_network_r_loads(tmp_path):
    """``path.pretrain_network_r`` through ``load_network``: a reference-layout
    ``.pth`` written from seeded weights (with running statistics) loads bit
    for bit into the frozen Ranker in ``extra``; so does the JAX Ranker's
    params pickle (carried by ``params_from_jax``; it holds no statistics)."""
    import pickle

    import jax
    import jax.numpy as jnp

    from ssl_tpu.archs.ranksrgan_arch import Ranker_VGG12_296 as JRanker
    from ssl_tpu_torch.archs import Ranker_VGG12_296
    from ssl_tpu_torch.utils.weight_port import params_from_jax

    src = Ranker_VGG12_296(nf=4)
    src.reset_parameters(torch.Generator().manual_seed(11))
    with torch.no_grad():
        for name, buf in src.named_buffers():
            if "running" in name:
                buf.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(12))
    torch.save({"params": src.state_dict()}, tmp_path / "ranker.pth")
    variables = JRanker(nf=4).init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    with open(tmp_path / "ranker.pkl", "wb") as f:
        pickle.dump({"params": params}, f)
    for path, want in (("ranker.pth", src.state_dict()),
                       ("ranker.pkl", params_from_jax("Ranker_VGG12_296", params))):
        opt = train_opt("RankSRGANPISSL")
        opt["path"]["pretrain_network_r"] = str(tmp_path / path)
        net_r = build_model(opt, device="cpu").init_state(seed=0).extra["net_r"]
        got = net_r.state_dict()
        assert not net_r.training
        for k, v in want.items():
            assert torch.equal(got[k], v), (path, k)
