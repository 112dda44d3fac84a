"""A tiny KAIR file through the port's train and test CLIs on the CPU
(``tests/torch_kair_cases.py``: BSRGANRRDBNet nf 8 / nb 1 / gc 4 on 64^2 GT
PNGs cropped to 32 and degraded by the BSRGAN chain to LQ 8, batch 2):

* ``python -m ssl_tpu_torch.train`` / ``.test`` with ``--device cpu``: the
  KAIR file trains 3 iterations with a checkpoint and validation, and the
  test CLI's ``BSGRANTestModel`` evaluates its ``net_g``;
* iteration 1's l_pix, l_selfsim and l_selfsim_kl against the JAX CLI's on
  the same file and G (a JAX ``.pkl``), within rtol 1e-4 (the train step's
  tolerance): with ``dataloader_num_workers`` 0 both draw the same crops,
  flips and degradations from the seeded global streams;
* 2 iterations, then ``--auto_resume`` to 4, end in the state of 4 straight
  iterations, bit for bit;
* the test CLI through ``BSGRANTestModel`` against JAX's on one ``.pkl``,
  whole and tiled: PSNR within 1e-3 dB, SSIM within 1e-4, the images within
  one uint8 level (tests/test_torch_recipe_cli.py's tolerances)."""

import copy
import os
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

import ssl_tpu.test as jtest
import ssl_tpu.train as jtrain
import ssl_tpu_torch.test as ttest
import ssl_tpu_torch.train as ttrain
from ssl_tpu.models import build_model as jax_build_model
from ssl_tpu.utils import logger as jlogger
from ssl_tpu_torch.utils import logger as tlogger
from torch_cli_cases import METRICS, write_dataset
from torch_kair_cases import REPO, tiny_kair, write_json

G = {"type": "BSRGANRRDBNet", "in_nc": 3, "out_nc": 3, "nf": 8, "nb": 1, "gc": 4, "sf": 4}
LOGGED = ("l_pix", "l_selfsim", "l_selfsim_kl")


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread (the suite runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("kair_cli_data")), n_train=4, gt=64)


@pytest.fixture(scope="module")
def jax_g(tmp_path_factory):
    """A JAX BSRGANRRDBNet's ``net_g_1.pkl`` (its own seeded init)."""
    root = str(tmp_path_factory.mktemp("kair_g"))
    jmodel = jax_build_model({"model_type": "BSGRANTestModel", "scale": 4, "num_devices": 1,
                              "network_g": dict(G), "path": {}, "is_train": False})
    jstate = jmodel.init_state(lq_shape=(1, 16, 16, 3))
    jmodel.save_networks(jax.device_get(jstate), root, 1)
    return os.path.join(root, "net_g_1.pkl")


def _test_opt(d, weights, name, **extra):
    return dict({"name": name, "model_type": "BSGRANTestModel", "scale": 4, "num_devices": 1,
                 "manual_seed": 0, "datasets": {"test_1": {
                     "name": "synthval", "type": "PairedImageDataset", "dataroot_gt": d["vgt"],
                     "dataroot_lq": d["vlq"], "io_backend": {"type": "disk"}}},
                 "network_g": dict(G), "path": {"pretrain_network_g": weights,
                                                "param_key_g": "params"},
                 "val": {"save_img": True, "metrics": METRICS}}, **extra)


def _tensors(state):
    out = {}
    for name in ("net_g", "net_g_ema", "net_d"):
        out.update({f"{name}.{k}": v for k, v in getattr(state, name).state_dict().items()})
    for name in ("opt_g", "opt_d"):
        for pid, st in getattr(state, name).state_dict()["state"].items():
            out.update({f"{name}.{pid}.{k}": v for k, v in st.items()})
    return out


def test_kair_file_through_both_clis_on_cpu(folders, tmp_path):
    """The two entry points as a user calls them, in subprocesses."""
    root = str(tmp_path)
    k = tiny_kair(folders, "kair_cli", iterations=3, checkpoint_test=3)
    train = write_json(k, os.path.join(root, "train.json"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-m", "ssl_tpu_torch.train", "-opt", train,
                          "--device", "cpu"], cwd=root, env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    exp = os.path.join(root, "experiments", "kair_cli")
    for f in ("models/net_g_2.pth", "models/net_g_3.pth", "models/net_d_3.pth",
              "training_states/3.state"):
        assert os.path.isfile(os.path.join(exp, f)), f
    log = "".join(open(os.path.join(exp, f)).read() for f in os.listdir(exp)
                  if f.startswith("train_") and f.endswith(".log"))
    for key in LOGGED + ("l_percep", "l_g_gan", "l_d_real", "l_d_fake"):
        assert f"{key}: " in log, key
    assert "Validation synthval" in log
    test = write_json(_test_opt(folders, os.path.join(exp, "models", "net_g_3.pth"), "kair_test",
                                path={"pretrain_network_g": os.path.join(
                                    exp, "models", "net_g_3.pth"), "param_key_g": "params_ema"}),
                      os.path.join(root, "test.json"))
    run = subprocess.run([sys.executable, "-m", "ssl_tpu_torch.test", "-opt", test, "--device",
                          "cpu"], cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    vis = os.path.join(root, "results", "kair_test", "visualization", "synthval")
    assert sorted(os.listdir(vis)) == ["v0_kair_test.png", "v1_kair_test.png"]


def _recording(monkeypatch, logger_cls):
    seen = []
    call = logger_cls.__call__

    def record(self, log_vars):
        seen.append(dict(log_vars))
        return call(self, log_vars)
    monkeypatch.setattr(logger_cls, "__call__", record)
    return seen


def test_first_iteration_losses_match_jax_cli(folders, jax_g, tmp_path, monkeypatch):
    root = str(tmp_path)
    runs = {}
    for name, cli, logger_cls, extra in (
            ("torch", ttrain, tlogger.MessageLogger, ["--device", "cpu"]),
            ("jax", jtrain, jlogger.MessageLogger, [])):
        k = tiny_kair(folders, f"first_{name}", iterations=1, perceptual=False,
                      pretrained_g=jax_g, checkpoint_save=100)
        seen = _recording(monkeypatch, logger_cls)
        cli.train_pipeline(root, ["-opt", write_json(k, os.path.join(root, f"{name}.json")),
                                  "--force_yml", "path:param_key_g=params", "num_devices=1"]
                          + extra)
        assert [s["iter"] for s in seen] == [1]
        runs[name] = seen[0]
        monkeypatch.undo()
    for key in LOGGED:
        assert np.isfinite(runs["torch"][key])
        np.testing.assert_allclose(runs["torch"][key], runs["jax"][key], rtol=1e-4, err_msg=key)
    assert runs["torch"]["l_selfsim"] > 0


def test_resume_2_plus_2_equals_4_bit_for_bit(folders, tmp_path):
    straight_root, broken_root = str(tmp_path / "straight"), str(tmp_path / "broken")
    k = tiny_kair(folders, "kair_resume", iterations=4)
    path = write_json(k, str(tmp_path / "k.json"))
    straight = ttrain.train_pipeline(straight_root, ["-opt", path, "--device", "cpu"])
    ttrain.train_pipeline(broken_root, ["-opt", path, "--device", "cpu", "--force_yml",
                                        "train:total_iter=2"])
    resumed = ttrain.train_pipeline(broken_root, ["-opt", path, "--device", "cpu",
                                                  "--auto_resume"])
    assert resumed.step == straight.step == 4
    want, got = _tensors(straight), _tensors(resumed)
    assert set(want) == set(got)
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    assert not differ, differ[:5]


@pytest.mark.parametrize("tiled", [False, True])
def test_test_cli_matches_jax(folders, jax_g, tmp_path, tiled):
    root = str(tmp_path)
    results, images = {}, {}
    for name, cli, extra in (("jax", jtest, []), ("torch", ttest, ["--device", "cpu"])):
        run = f"kair_{name}_{'tiled' if tiled else 'whole'}"
        opt = _test_opt(folders, jax_g, run, tile_process=tiled, tile_size=8, tile_pad=4)
        results[name] = cli.test_pipeline(root, ["-opt", write_json(
            copy.deepcopy(opt), os.path.join(root, f"{run}.json"))] + extra)["synthval"]
        vis = os.path.join(root, "results", run, "visualization", "synthval")
        images[name] = [cv2.imread(os.path.join(vis, f"v{i}_{run}.png")).astype(int)
                        for i in range(2)]
    assert abs(results["torch"]["psnr"] - results["jax"]["psnr"]) < 1e-3
    assert abs(results["torch"]["ssim"] - results["jax"]["ssim"]) < 1e-4
    for a, b in zip(images["torch"], images["jax"]):
        assert a.shape == b.shape and np.abs(a - b).max() <= 1
