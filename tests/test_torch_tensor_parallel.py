"""The diffusion tree on torch.distributed: ``parallel/tensor.py``'s
Megatron plan and ZeRO-1 against ``ssl_tpu.parallel.tensor``, the
tensor-parallel and data-parallel mini-steps, and tiles sampled in parallel.

* The plan: on the tiny UNet and struct-cond encoder of
  tests/torch_diffusion_cases.py, every parameter's split (its flax path
  through ``utils/weight_port.py``) equals ``tp_spec``'s, and every AdamW
  moment's equals ``state_tp_shardings``'s with ``zero``; no processes.
* The mini-steps (gloo, world 2): a mini-step split over ``model`` with
  ZeRO (data 1 x tp 2), and one over ``data`` (data 2 x tp 1, one row a
  rank), from seeded weights with nothing at 0, equal the port's one-rank
  mini-step on the same global batch, which tests/test_torch_diffusion_train.py
  holds against JAX.  Tolerances are
  that file's: losses rtol 1e-4, weights and EMA within lr / 5 where the
  gradient is resolved (tests/torch_diffusion_train_cases.py::check_weights).
  Each attention call sees heads / tp heads, which is what K2's wrappers
  plan their launches for.
* ``tiled_sample(data_parallel=True)`` at world 2 equals the serial canvas
  with a deterministic sample function (ddim's is one), on 5 tiles: a short
  last group."""

import os

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from torch_diffusion_cases import CFG, STRUCT, UNET, VAE, close, nchw
from torch_diffusion_train_cases import SSG, batch, check_weights

CONFS = {"cfg": CFG, "unet": UNET, "struct": STRUCT, "vae": VAE, "ssg": SSG,
         "ssl": dict(mask_stride=3, l1_weight=0.5, kl_weight=0.5, capacity=64)}


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread in this process too: the suite runs several test
    processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_params():
    from ssl_tpu_torch.diffusion.unet import EncoderUNetModelWT, UNetModelDualcondV2
    return {"unet": UNetModelDualcondV2(**UNET), "structcond": EncoderUNetModelWT(**STRUCT),
            "null_context": torch.zeros(CFG["context_len"], CFG["context_dim"])}


def test_plan_matches_jax_tp_spec_and_zero():
    from jax.sharding import PartitionSpec as P
    from ssl_tpu.parallel.tensor import create_dp_tp_mesh, state_tp_shardings
    from ssl_tpu_torch.parallel.tensor import state_plan, torch_dim
    from ssl_tpu_torch.utils.weight_port import params_to_jax, unet_flax_path
    params = _port_params()
    tree = params_to_jax("StableSRSSL", params)
    jax_state = {"params": tree, "opt_state": {"mu": tree}, "ema_params": tree}
    specs = state_tp_shardings(jax_state, create_dp_tp_mesh(1, 2), zero=True,
                               zero_min_size=128)
    plan = state_plan(params, 2, zero=True, zero_min_size=128)
    n_split = n_zero = 0
    for key, dim in plan["params"].items():
        net, _, name = key.partition(".")
        shape = (params[net].get_parameter(name).shape if name else params[net].shape)
        path = [net, *unet_flax_path(name, len(shape))] if name else [net]

        def model_dim(spec_tree):
            node = spec_tree
            for k in path:
                node = node[k]
            spec = tuple(node.spec) + (None,) * len(shape)
            dims = [d for d in range(len(shape)) if spec[d] == "model"]
            if not dims:
                return None
            return dims[0] if key == "null_context" else torch_dim(dims[0], len(shape))

        assert dim == model_dim(specs["params"]), key
        assert plan["moments"][key] == model_dim(specs["opt_state"]["mu"]), key
        n_split += dim is not None
        n_zero += dim is None and plan["moments"][key] is not None
    assert n_split > 20 and n_zero > 10
    assert specs["params"]["unet"]["input_blocks_1_0"]["in_layers_2"]["kernel"].spec == \
        P(None, None, None, "model")


@pytest.fixture(scope="module")
def one_rank():
    """Seeded weights with nothing at 0 (at init the zero layers would hide
    every attention), the global batch (2 rows) and the one-rank reference."""
    from ssl_tpu_torch.diffusion.unet import init_params
    from ssl_tpu_torch.diffusion.vae import AutoencoderKL
    gen = torch.Generator().manual_seed(0)
    nets = {**_port_params(), "vae": AutoencoderKL(**VAE)}
    sds = {}
    with torch.no_grad():
        for name, net in nets.items():
            if name == "null_context":
                sds[name] = torch.randn(net.shape, generator=gen) * 0.5
                continue
            init_params(net, gen)
            for p in net.parameters():
                p.add_(torch.randn(p.shape, generator=gen) * 0.05)
            sds[name] = net.state_dict()
    b = {k: nchw(v) for k, v in batch(0).items()}
    ref = cases.diffusion_steps(0, 1, {}, CONFS, sds, b, 1)
    return sds, b, ref


PARALLEL = {"tp2_zero": {"data": 1, "tp": 2, "zero": True, "zero_min_size": 128},
            "data2": {"data": 2, "tp": 1}}
TILES_Z = torch.from_numpy(np.random.RandomState(3).randn(1, 4, 8, 28).astype(np.float32))


@pytest.fixture(scope="module")
def cli_cfg(tmp_path_factory):
    """tests/test_torch_diffusion_train_cli.py's tiny config on 4 seeded GT
    PNGs and masks: 2 mini-steps, accumulate 2, a checkpoint at 2."""
    import cv2
    from scipy.io import savemat
    from test_torch_diffusion_train_cli import tiny_cfg, write_cfg
    root = tmp_path_factory.mktemp("tp_cli")
    os.makedirs(root / "gt")
    os.makedirs(root / "mask")
    rng = np.random.RandomState(0)
    for i in range(4):
        cv2.imwrite(str(root / "gt" / f"img{i}.png"), (rng.rand(48, 48, 3) * 255).astype(np.uint8))
        savemat(str(root / "mask" / f"img{i}.mat"),
                {"mat": (rng.rand(48, 48) < 0.2).astype(np.float64)})
    return root, write_cfg(root, "cfg.json", tiny_cfg(root))


def _cli_argv(cli_cfg, name, *overrides):
    root, base = cli_cfg
    return ["--train", "--base", base, "--logdir", str(root / name), "--device", "cpu",
            *overrides]


@pytest.fixture(scope="module")
def world2(one_rank, cli_cfg):
    """One gloo world of 2 ranks for every case of this file: the mini-step
    on each mesh of PARALLEL, the tiles, then the training CLI split over
    ``model`` with ZeRO; results by case, per rank."""
    sds, b, _ = one_rank
    calls = [(cases.diffusion_steps, (par, CONFS, sds, b, 1)) for par in PARALLEL.values()]
    calls += [(cases.tiles, (TILES_Z,)),
              (cases.diffusion_cli, (_cli_argv(cli_cfg, "tp", "parallel.tp=2", "parallel.zero=true",
                                               "parallel.zero_min_size=128"),))]
    ranks = cases.run_world(cases.in_one_world, 2, calls)
    return {name: [r[i] for r in ranks] for i, name in enumerate([*PARALLEL, "tiles", "cli"])}


@pytest.mark.parametrize("case", list(PARALLEL))
def test_two_rank_mini_steps_match_one_rank(one_rank, world2, case):
    sds, b, ref = one_rank
    parallel, ranks = PARALLEL[case], world2[case]
    tp = parallel["tp"]
    assert [r["rows"] for r in ranks] == [2 // parallel["data"]] * 2
    assert ranks[0]["heads"] and set(ranks[0]["heads"]) == {h // tp for h in set(ref["heads"])}
    grads = ref["grads"]
    for r in ranks:
        for got, want in zip(r["logs"], ref["logs"]):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
        for tree, scale in (("params", 1.0), ("ema", 0.9)):     # the EMA moves 0.9 of it
            flat = {f"{net}.{k}": v for net in r[tree] for k, v in r[tree][net].items()}
            want = {f"{net}.{k}": v for net in ref[tree] for k, v in ref[tree][net].items()}
            check_weights(flat, want, grads, scale=scale)
    for tree in ("params", "ema"):
        for net in ranks[0][tree]:
            for k, v in ranks[0][tree][net].items():
                assert torch.equal(v, ranks[1][tree][net][k]), (tree, net, k)


def test_tiles_in_parallel_equal_the_serial_canvas(world2):
    from ssl_tpu_torch.diffusion.sampler import tiled_sample
    serial = tiled_sample(cases.tile_fn, TILES_Z, tile=8, overlap=2)
    for got in world2["tiles"]:
        assert torch.equal(got, serial)


def test_training_cli_split_over_model_matches_one_rank(world2, cli_cfg):
    """``diffusion.main --train parallel.tp=2 parallel.zero=true`` at world 2:
    rank 0 writes the one-rank run's files: the weights of ``ckpt_2.pkl``
    (after one AdamW update) within lr / 5 of the one-rank CLI's, and the
    AdamW moments of ``train_state_2.pkl``, gathered whole, within rtol 1e-4
    and an atol of 1e-5 of each moment's largest value."""
    import pickle

    from ssl_tpu_torch.diffusion import main as dmain
    dmain.main(_cli_argv(cli_cfg, "one"))
    root = cli_cfg[0]

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            return {k: v for key in tree for k, v in leaves(tree[key], f"{path}/{key}").items()}
        return {path: np.asarray(tree)}

    def ckpt(run):
        with open(root / run / "ckpt_2.pkl", "rb") as f:
            return leaves(pickle.load(f))

    got, want = ckpt("tp"), ckpt("one")
    assert got.keys() == want.keys()
    lr = 1e-4                                          # tiny_cfg's
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=lr / 5, err_msg=k)
    s_tp, s_one = (torch.load(root / run / "train_state_2.pkl", weights_only=True)
                   for run in ("tp", "one"))
    assert s_tp["step"] == s_one["step"] == 2
    assert s_tp["opt"]["state"].keys() == s_one["opt"]["state"].keys()
    for i, st in s_one["opt"]["state"].items():
        for k, v in st.items():
            assert s_tp["opt"]["state"][i][k].shape == v.shape, (i, k)
            close(s_tp["opt"]["state"][i][k].numpy(), v.numpy())
