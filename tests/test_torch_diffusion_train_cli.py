"""The port's StableSR-SSL training CLI (``python -m
ssl_tpu_torch.diffusion.main --train``) on the CPU, against ``ssl_tpu``.

A tiny config like tests/test_diffusion_train_cli.py:37-59 (crop 32, UNet 32
[1, 2], VAE 16, SSL 9 / 5), 6 GT PNGs of 48^2 with ``.mat`` masks, no loader
processes:

* 2 mini-steps on ``--device cpu`` from a ``.json`` base file with ``yaml``
  hidden, then ``--resume auto`` to 4 (and 2 more with a zoo strategy as an
  override); ``ckpt_2.pkl`` has the JAX CLI's
  layout (every leaf's path, shape and dtype of the JAX model's params), and
  ``train_state_2.pkl`` reloads into a fresh state bit for bit.
* ``params_to_jax(params_from_jax(p))`` is ``p`` bit for bit.
* ``apply_dotlist`` agrees with JAX's (and, without ``yaml``, on values
  that read alike as JSON).
* The CLI's first degraded batch equals the JAX pipeline's under the same
  seeds (loader order, crops, flips, kernels and the degrader's draws), the
  LQ within one uint8 level on at most 0.1% of its values, with the Poisson
  draws injected in both (tests/torch_host_degrade_cases.py)."""

import json
import os
import pickle
import random
import re
import sys
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import savemat

from ssl_tpu.data import build_dataset as jax_build_dataset
from ssl_tpu.data.loader import collate
from ssl_tpu.data.realesr_degradation import RealESRGANDegrader as JDegrader
from ssl_tpu.diffusion import main as jmain
from ssl_tpu_torch.data.realesr_degradation import RealESRGANDegrader
from ssl_tpu_torch.diffusion import main as tmain
from ssl_tpu_torch.diffusion.ddpm_ssl import StableSRSSL, trainable
from ssl_tpu_torch.utils.weight_port import params_from_jax, params_to_jax
from torch_diffusion_cases import seeded_params
from torch_host_degrade_cases import check_levels, det_poisson, with_det_poisson

N_IMAGES, IMAGE, CROP = 6, 48, 32


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread (the suite runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("diffusion_cli")
    gt, mask = root / "gt", root / "mask"
    os.makedirs(gt)
    os.makedirs(mask)
    rng = np.random.RandomState(0)
    for i in range(N_IMAGES):
        cv2.imwrite(str(gt / f"img{i}.png"), (rng.rand(IMAGE, IMAGE, 3) * 255).astype(np.uint8))
        savemat(str(mask / f"img{i}.mat"),
                {"mat": (rng.rand(IMAGE, IMAGE) < 0.2).astype(np.float64)})
    return root


def tiny_cfg(root, **train):
    return {
        "model": {"timesteps": 50, "beta_schedule": "linear", "parameterization": "eps",
                  "scale_factor": 0.18215, "context_dim": 32,
                  "unet": {"model_channels": 32, "num_res_blocks": 1, "channel_mult": [1, 2],
                           "attention_resolutions": [2], "num_head_channels": 8},
                  "first_stage": {"embed_dim": 4, "ch": 16, "ch_mult": [1, 2, 2, 2],
                                  "num_res_blocks": 1}},
        "sslopt": {"kernel_size_search": 9, "kernel_size_window": 5, "mask_stride": 3,
                   "l1_weight": 0.5, "kl_weight": 0.5, "sigma": 0.1},
        "degradation": {"noise_range": [1, 15], "jpeg_range": [60, 95], "queue_size": 0,
                        "no_degradation_prob": 0.0},
        "data": {"crop_size": CROP, "batch_size": 2, "num_workers": 0,
                 "train": {"type": "TwoStageDegradationImgMaskDataset",
                           "dataroot_gt": str(root / "gt"),
                           "dataroot_gt_mask": str(root / "mask")}},
        "train": {"lr": 1e-4, "max_steps": 2, "log_every": 1, "save_every": 2, "image_every": 2,
                  "accumulate_grad_batches": 2, **train},
    }


def write_cfg(root, name, cfg):
    path = str(root / name)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def layout(tree, path=""):
    """{leaf path: (shape, dtype)} of a params tree."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in layout(tree[key], f"{path}/{key}").items()}
    return {path: (tuple(tree.shape), np.dtype(tree.dtype).name)}


@pytest.fixture(scope="module")
def jax_params(data):
    """The JAX CLI's params tree for the tiny config's UNet and struct-cond
    encoder, seeded non-zero (tests/torch_diffusion_cases.py), and a null
    context of the port's shape."""
    jmodel = jmain.build_from_config(tiny_cfg(data))
    z, t = jnp.zeros((1, CROP // 8, CROP // 8, 4)), jnp.zeros((1,), jnp.int32)
    p_enc = seeded_params(jmodel.structcond, z, t, seed=1)
    feats = jax.eval_shape(lambda: jmodel.structcond.apply({"params": p_enc}, z, t))
    feats = jax.tree_util.tree_map(lambda f: jnp.zeros(f.shape, f.dtype), feats)
    ctx = jnp.zeros((1, jmodel.cfg.context_len, jmodel.cfg.context_dim))
    p_unet = seeded_params(jmodel.unet, z, t, ctx, feats, seed=2)
    null = np.random.RandomState(3).randn(jmodel.cfg.context_len, jmodel.cfg.context_dim)
    return jax.tree_util.tree_map(np.asarray, {"unet": p_unet, "structcond": p_enc,
                                               "null_context": null.astype(np.float32)})


def test_cli_two_mini_steps_then_resume_to_four(data, jax_params, tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setitem(sys.modules, "yaml", None)        # a .json base file needs none
    cfg = tiny_cfg(data)
    base = write_cfg(tmp_path, "cfg.json", cfg)
    logdir = tmp_path / "logs"
    state = tmain.main(["--train", "--base", base, "--logdir", str(logdir), "--device", "cpu"])
    assert state.step == 2 and state.mini_step == 0 and "step 2 (" in capsys.readouterr().out
    for f in ("ckpt_2.pkl", "train_state_2.pkl", "images/train/pred_x0_gs-000002.png"):
        assert (logdir / f).is_file(), f
    with open(logdir / "ckpt_2.pkl", "rb") as f:
        ckpt = pickle.load(f)
    assert set(ckpt) == {"unet", "structcond", "null_context"}
    assert layout(ckpt) == layout(jax_params)
    # the training state, reloaded into a fresh state, bit for bit
    model = tmain.build_from_config(cfg)
    fresh = model.init_state(seed=1, device="cpu")
    degrader = RealESRGANDegrader(cfg["degradation"], scale=1, queue_size=0, seed=1)
    tmain.load_train_state(str(logdir / "train_state_2.pkl"), fresh, degrader)
    for name in ("params", "ema_params"):
        for a, b in zip(trainable(getattr(state, name)), trainable(getattr(fresh, name))):
            assert torch.equal(a, b)
    assert fresh.opt.state_dict()["state"].keys() == state.opt.state_dict()["state"].keys()
    assert torch.equal(fresh.generator.get_state(), state.generator.get_state())

    resumed = tmain.main(["--train", "--base", base, "--logdir", str(logdir), "--device", "cpu",
                          "--resume", "auto", "train.max_steps=4", "train.save_every=4"])
    out = capsys.readouterr().out
    assert "resumed from" in out and "train_state_2.pkl at step 2" in out and "step 3 (" in out
    assert resumed.step == 4 and (logdir / "train_state_4.pkl").is_file()


def test_cli_trains_with_a_zoo_strategy(data, tmp_path, monkeypatch, capsys):
    """2 mini-steps (one update) with ``sslopt.simself_strategy`` and a zoo
    option as overrides: the SSL term goes through the strategy zoo, with
    finite losses and l_selfsim > 0."""
    from ssl_tpu_torch.losses import simself_strategies
    seen = []
    loss_fn = simself_strategies.simself_strategy_loss

    def spy(sr, gt, mask, setting):
        seen.append((setting.strategy, dict(setting.strategy_opts), setting.capacity))
        return loss_fn(sr, gt, mask, setting)
    monkeypatch.setattr(simself_strategies, "simself_strategy_loss", spy)
    base = write_cfg(tmp_path, "cfg.json", tiny_cfg(data, save_every=100, image_every=100))
    state = tmain.main(["--train", "--base", base, "--logdir", str(tmp_path / "logs"),
                        "--device", "cpu", "sslopt.simself_strategy=areaarea_mask_nonlocal_cuda_v1",
                        "sslopt.kernel_size=9"])
    assert state.step == 2 and state.mini_step == 0
    assert seen == [("areaarea_mask_nonlocal_cuda_v1", {"kernel_size": 9}, 2048)] * 2
    logged = re.findall(r"'l_selfsim': ([^,}]+)", capsys.readouterr().out)
    assert len(logged) == 2
    for value in map(float, logged):
        assert np.isfinite(value) and value > 0, logged


def test_params_round_trip_bit_for_bit(jax_params):
    """The JAX CLI's params tree -> the port's modules -> ``params_to_jax``."""
    back = params_to_jax("StableSRSSL", params_from_jax("StableSRSSL", jax_params))
    assert layout(back) == layout(jax_params)
    flat, _ = jax.tree_util.tree_flatten_with_path(jax_params)
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        assert isinstance(node, np.ndarray) and node.flags.c_contiguous
        assert np.array_equal(node, leaf), path


OVERRIDES = ["train.max_steps=3", "train.lr=2e-4", "model.use_flash_attention=true",
             "data.batch_size=4", "model.unet.channel_mult=[1, 2, 4]", "sslopt.impl=dense",
             "degradation.no_degradation_prob=0.01", "model.ckpt_path=null"]
JSON_ALIKE = [o for o in OVERRIDES if "channel_mult" not in o and "impl" not in o]


def test_apply_dotlist_matches_jax(monkeypatch):
    def base():
        return {"train": {"max_steps": 800000}, "model": {"unet": {"channel_mult": [1, 2]}}}
    assert tmain.apply_dotlist(base(), OVERRIDES) == jmain.apply_dotlist(base(), OVERRIDES)
    want = jmain.apply_dotlist(base(), JSON_ALIKE)
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert tmain.apply_dotlist(base(), JSON_ALIKE) == want
    assert want["train"]["lr"] == 2e-4 and want["model"]["use_flash_attention"] is True
    with pytest.raises(SystemExit):
        tmain.apply_dotlist(base(), ["train.max_steps"])


def test_first_degraded_batch_matches_jax(data, tmp_path, monkeypatch):
    """The port CLI (seed 0) against the JAX pipeline built by hand as its
    CLI builds it: the loader's epoch-0 permutation of RandomState(0), the
    items under random / np.random seeded 0, the degrader at scale 1."""
    cfg = tiny_cfg(data)
    draw = RealESRGANDegrader.draw_plan

    def plan(self, b):
        p = draw(self, b)
        for stage in ("noise1", "noise2"):
            p[stage]["poisson"] = det_poisson
        return p
    monkeypatch.setattr(RealESRGANDegrader, "draw_plan", plan)
    seen = []

    class Stop(Exception):
        pass

    def first(self, state, batch, draws=None):
        seen.append({k: v.numpy().transpose(0, 2, 3, 1) for k, v in batch.items()})
        raise Stop
    monkeypatch.setattr(StableSRSSL, "train_step", first)
    args = types.SimpleNamespace(base=write_cfg(tmp_path, "cfg.json", cfg),
                                 logdir=str(tmp_path / "logs"), resume=None, overrides=[],
                                 device="cpu")
    with pytest.raises(Stop):
        tmain.train(args)

    random.seed(0)
    np.random.seed(0)
    dopt = {**cfg["data"]["train"], "phase": "train", "crop_size": CROP}
    jds = jax_build_dataset(dopt)
    order = np.random.RandomState(0).permutation(len(jds))[:2]
    batch = collate([jds[int(i)] for i in order])
    jdeg = with_det_poisson(JDegrader(cfg["degradation"], scale=1, queue_size=0, seed=0))
    want = jdeg({k: v for k, v in batch.items() if isinstance(v, np.ndarray)} | {"gt_size": CROP})
    got = seen[0]
    assert sorted(got) == sorted(want) == ["gt", "gt_mask", "lq"]
    assert np.array_equal(got["gt"], want["gt"]) and np.array_equal(got["gt_mask"], want["gt_mask"])
    check_levels(got["lq"], want["lq"])


@pytest.mark.parametrize("override,what", [
    ("train.ckpt_backend=orbax", "ckpt_backend"), ("parallel.tp=2", "parallel"),
    ("model.target=ldm.models.X", "model.target")])
def test_unported_options_raise(data, tmp_path, override, what, monkeypatch):
    """orbax is not ported; ``parallel`` beyond one rank needs a torchrun
    world of its size.  A ``model.target`` makes the model a reference-schema
    one, which translates (diffusion/ref_config.py) and builds: with no
    ``params`` the reference's default model (context_dim 1024), stopped
    here before its full-size weights are made."""
    base = write_cfg(tmp_path, "cfg.json", tiny_cfg(data))
    if what == "model.target":
        class Stop(Exception):
            pass

        built = []

        def stop(self, *args, **kwargs):
            built.append(self)
            raise Stop
        monkeypatch.setattr(StableSRSSL, "init_state", stop)
        with pytest.raises(Stop):
            tmain.main(["--train", "--base", base, "--logdir", str(tmp_path), "--device", "cpu",
                        override])
        assert built[0].cfg.context_dim == 1024 and built[0].cfg.timesteps == 1000
        return
    err, match = ((ValueError, "torchrun") if what == "parallel" else
                  (NotImplementedError, "ROADMAP.md"))
    with pytest.raises(err, match=match) as e:
        tmain.main(["--train", "--base", base, "--logdir", str(tmp_path), "--device", "cpu",
                    override])
    assert what in str(e.value)


def test_cli_runs_on_cuda_unless_told(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = write_cfg(tmp_path, "cfg.json", tiny_cfg(data))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain.main(["--train", "--base", base, "--logdir", str(tmp_path)])
