"""The port's data parallelism on torch.distributed (gloo worlds on the CPU)
against the global-batch step: ``parallel/mesh.py``, ``parallel/fsdp.py``,
the couplings of the JAX step's global batch (the relativistic means, the
SSL edge count, the D's batch-norm statistics), the gathered checkpoints,
and the option rules.

Reference: the port's world-1 step on the global batch, which
tests/test_torch_train_step.py holds against the JAX step; for the 2-D
(data, fsdp) mesh, the JAX step itself, jitted, in
tests/test_parallel.py::test_fsdp_param_sharding_train_step's setup.
Tolerances are tests/test_torch_train_step.py's: losses rtol 1e-4,
parameters atol 2e-5 (= lr / 5), batch-norm statistics rtol 1e-4, atol 1e-5.
The ranks run in spawned processes (tests/torch_dist_cases.py)."""

import copy
import os

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from ssl_tpu_torch.metrics.metric_util import exact_float32
from ssl_tpu_torch.parallel import mesh as tmesh

LOSSES = ("l_pix", "l_selfsim", "l_selfsim_kl", "l_g_gan", "l_d_real", "l_d_fake", "l_g_total")
PARAM_ATOL = 2e-5


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread in this process too: the suite runs several test
    processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_nets(got: dict, ref: dict, what: str):
    for net in ref:
        for k, v in ref[net].items():
            tol = dict(rtol=1e-4, atol=1e-5) if "running" in k else dict(rtol=0, atol=PARAM_ATOL)
            np.testing.assert_allclose(got[net][k].numpy(), v.numpy(), err_msg=f"{what} {net} {k}",
                                       **tol)


def _equal_nets(a: dict, b: dict):
    for net in b:
        assert a[net].keys() == b[net].keys()
        for k in b[net]:
            assert torch.equal(a[net][k], b[net][k]), f"{net} {k} differs across ranks"


def test_two_rank_esrgan_ssl_steps_match_the_global_batch():
    """World 2, batch 2 a rank, the two ranks' masks at different edge
    densities: three steps equal the world-1 step on the 4 rows, with the
    relativistic means, the SSL count and the D's batch statistics global;
    the ranks' nets are identical."""
    opt, batch = cases.esrgan_opt(), cases.gan_batch()
    counts = [float(batch["gt_mask"][i:i + 2].sum()) for i in (0, 2)]
    assert counts[0] > 2 * counts[1]            # a per-rank count would show
    ranks = cases.run_world(cases.train_steps, 2, opt, batch, 3)
    ref = cases.train_steps(0, 1, opt, batch, 3)["runs"]
    assert [r["rows"] for r in ranks] == [2, 2]
    for step in range(3):
        logs, nets = ranks[0]["runs"][step]
        for k in LOSSES:
            np.testing.assert_allclose(logs[k], ref[step][0][k], rtol=1e-4, err_msg=f"{step} {k}")
        _close_nets(nets, ref[step][1], f"step {step + 1}")
        _equal_nets(ranks[1]["runs"][step][1], nets)
    assert ranks[0]["runs"][2][0]["lr"] == pytest.approx(0.5e-4)


def test_four_rank_fsdp_step_matches_jax():
    """World 4 as data 2 x fsdp 2 (tests/test_parallel.py's FSDP setup:
    SRModel, RRDBNet nf 8 / nb 4, batch 4, L1): the RRDBs are sharded over
    fsdp, the two ranks of a data index take the same rows, G's Adam updates
    parameter by parameter, and one step equals the JAX step on the global
    batch."""
    import jax
    import jax.numpy as jnp
    from ssl_tpu.models import build_model as jax_build_model
    from ssl_tpu_torch.utils.weight_port import params_from_jax
    opt = {"name": "fsdp", "model_type": "SRModel", "scale": 4, "is_train": True,
           "manual_seed": 0, "datasets": {"train": {"gt_size": 32}},
           "network_g": {"type": "RRDBNet", "num_feat": 8, "num_block": 4, "num_grow_ch": 4},
           "path": {}, "parallel": {"fsdp": 2, "fsdp_min_size": 32},
           "train": {"ema_decay": 0.999, "optim_g": {"type": "Adam", "lr": 1e-4},
                     "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0}}}
    jopt = {k: v for k, v in opt.items() if k != "parallel"}
    jmodel = jax_build_model(copy.deepcopy(jopt))
    jstate = jmodel.init_state(lq_shape=(4, 8, 8, 3))
    rng = np.random.RandomState(0)
    lq, gt = rng.rand(4, 8, 8, 3).astype(np.float32), rng.rand(4, 32, 32, 3).astype(np.float32)
    params = params_from_jax("RRDBNet", jax.tree_util.tree_map(np.asarray, jstate.params_g))
    batch = {"lq": torch.from_numpy(lq.transpose(0, 3, 1, 2).copy()),
             "gt": torch.from_numpy(gt.transpose(0, 3, 1, 2).copy())}

    def jax_step():
        new, logs = jax.jit(jmodel.make_train_step())(
            jstate, {"lq": jnp.asarray(lq), "gt": jnp.asarray(gt)})
        return (float(logs["l_pix"]),
                params_from_jax("RRDBNet", jax.tree_util.tree_map(np.asarray, new.params_g)),
                params_from_jax("RRDBNet", jax.tree_util.tree_map(np.asarray, new.ema_params_g)))

    ranks, (j_loss, j_g, j_ema) = cases.run_world(cases.sr_fsdp_step, 4, opt, batch, params,
                                                 after_start=jax_step)
    # the RRDBs shard over fsdp and replicate over data; the rest stays whole
    placements = ranks[0]["placements"]
    assert {k.split(".")[1] for k in placements} == {"0", "1", "2", "3"}
    assert all(k.startswith("body.") for k in placements)
    assert set(placements.values()) == {"(Replicate(), Shard(dim=0))"}
    # one foreach call may not mix sharded and whole parameters (CUDA's default)
    assert ranks[0]["foreach"] == [False]
    assert torch.equal(ranks[0]["lq"], ranks[1]["lq"]) and torch.equal(ranks[0]["lq"],
                                                                       batch["lq"][:2])
    assert torch.equal(ranks[2]["lq"], batch["lq"][2:])
    for r in ranks:
        np.testing.assert_allclose(r["logs"]["l_pix"], j_loss, rtol=1e-4)
        _close_nets({"g": r["g"], "g_ema": r["g_ema"]}, {"g": j_g, "g_ema": j_ema}, "fsdp")
        _equal_nets({"g": r["g"]}, {"g": ranks[0]["g"]})


def test_fsdp_training_state_resumes_at_world_1(tmp_path):
    """A training state saved at world 2 with G's RRDBs sharded (data 1 x
    fsdp 2) holds gathered, unprefixed tensors: it resumes at world 1 bit for
    bit (nets, EMA, D, both Adams, step), its net files load into the plain
    nets, and the resumed run steps on."""
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.models.base_model import load_network
    opt, batch = cases.esrgan_opt(fsdp=2, num_block=2), cases.gan_batch()
    ranks = cases.run_world(cases.train_steps, 2, opt, batch, 1, str(tmp_path))
    assert ranks[0]["sharded"] and all(k.startswith("body.") for k in ranks[0]["sharded"])
    saved = ranks[0]["runs"][0][1]
    assert sorted(os.listdir(tmp_path / "states")) == ["1.rank1.state", "1.state", "latest"]

    one = copy.deepcopy(opt)
    one["parallel"] = {}
    model = build_model(one, device="cpu")
    state, it = model.load_training_state(model.init_state(seed=0), str(tmp_path / "states"))
    assert it == 1 and state.step == 1
    _equal_nets(cases.snapshot(state), saved)
    payload = torch.load(tmp_path / "states" / "1.state", weights_only=True)
    for name, optim in (("opt_g", state.opt_g), ("opt_d", state.opt_d)):
        mine = optim.state_dict()["state"]
        assert len(mine) == len(payload[name]["state"]) > 0
        for i, s in mine.items():
            for k, v in s.items():
                assert torch.equal(v, payload[name]["state"][i][k]), (name, i, k)
    for name, net in (("net_g", model.build_g()), ("net_d", model.build_d(opt["network_d"], 1))):
        load_network(net, str(tmp_path / "models" / f"{name}_1.pth"))
        key = "g" if name == "net_g" else "d"
        assert all(torch.equal(v, saved[key][k]) for k, v in net.state_dict().items())
    state, logs = model.train_step(state, batch)
    assert state.step == 2 and all(np.isfinite(float(v)) for v in logs.values())


def test_option_rules():
    """num_devices must be auto or the world size, parallel.fsdp must divide
    it, and --launcher pytorch without torchrun's environment raises (naming
    the command) instead of training alone."""
    assert tmesh.resolve_mesh({"num_devices": "auto"}).world == 1
    assert tmesh.resolve_mesh({"num_devices": 1, "parallel": {"fsdp": 1}}).data == 1
    with pytest.raises(ValueError, match="torchrun"):
        tmesh.resolve_mesh({"num_devices": 2})
    with pytest.raises(ValueError, match="must divide"):
        tmesh.resolve_mesh({"parallel": {"fsdp": 2}})
    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
           if k in os.environ}
    try:
        with pytest.raises(RuntimeError, match="torchrun"):
            tmesh.init_distributed("cpu")
    finally:
        os.environ.update(env)
    batch = {"x": torch.arange(8).reshape(4, 2), "name": ["a"]}
    assert tmesh.shard_batch(batch, tmesh.resolve_mesh({})) is batch   # one rank keeps every row
    assert tmesh.shard_batch(batch, None) is batch


def test_exact_float32_keeps_cudnn_on():
    """The metrics' float32 guard turns off TF32 alone: cuDNN stays enabled,
    and both TF32 switches come back as they were."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            torch.backends.cuda.matmul.allow_tf32 = flag
            with exact_float32():
                assert torch.backends.cudnn.enabled
                assert not torch.backends.cudnn.allow_tf32
                assert not torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cudnn.enabled
            assert torch.backends.cudnn.allow_tf32 == flag
            assert torch.backends.cuda.matmul.allow_tf32 == flag
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
