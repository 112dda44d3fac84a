"""The port's SRModel inference, validation, checkpoints and CLIs against
ssl_tpu's, on a tiny RRDBNet (nf 8, nb 1, gc 4) whose seeded JAX weights
come across through ``params_from_jax``.

Tolerances: SR images rtol 1e-4 with an atol of 1e-5 of the largest |SR|
(float32 convolutions in other orders); validation PSNR within 1e-3 dB and
SSIM within 1e-4 (the uint8 rounding of an SR pixel near .5 may differ); a
training state saved after 2 steps and resumed for 2 more equals 4 steps
without a break bit for bit (CPU)."""

import copy
import os
import random
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import ssl_tpu_torch.test as tcli_test
import ssl_tpu_torch.train as tcli_train
from ssl_tpu.data import build_dataloader as jax_build_dataloader
from ssl_tpu.data import build_dataset as jax_build_dataset
from ssl_tpu.models import build_model as jax_build_model
from ssl_tpu.utils.weight_port import load_params_auto
from ssl_tpu_torch.data import build_dataloader, build_dataset
from ssl_tpu_torch.models import build_model
from ssl_tpu_torch.utils.weight_port import params_from_jax
from torch_cli_cases import eval_opt, train_opt, write_dataset, write_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the suite runs several test processes on the
    machine's cores, and torch's thread pools contending for them slow this
    file's many small CPU ops by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("cli_data")))


@pytest.fixture(scope="module")
def pair(folders):
    """(JAX model, JAX state, port model, port state): is_train false, the
    port's G carrying the JAX G's seeded weights."""
    opt = eval_opt(folders, None, is_train=False, tile_size=8, tile_pad=4)
    jmodel = jax_build_model(copy.deepcopy(opt))
    jstate = jmodel.init_state(lq_shape=(1, 16, 16, 3))
    tmodel = build_model(copy.deepcopy(opt), device="cpu")
    tstate = tmodel.init_state()
    assert tstate.opt_g is None and tstate.net_d is None and tstate.net_g_ema is None
    tstate.net_g.load_state_dict(params_from_jax("RRDBNet", jax.tree_util.tree_map(
        np.asarray, jstate.params_g)))
    return jmodel, jstate, tmodel, tstate


def _assert_sr_close(got, want):
    got = got.numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("tile", [False, True])
def test_test_and_tile_process_match_jax(pair, tile):
    jmodel, jstate, tmodel, tstate = pair
    jmodel.opt["tile_process"] = tmodel.opt["tile_process"] = tile
    lq = np.random.RandomState(1).rand(1, 21, 27, 3).astype(np.float32)
    want = np.asarray(jmodel.test(jstate, lq))
    got = tmodel.test(tstate, torch.from_numpy(lq.transpose(0, 3, 1, 2).copy()))
    assert tuple(got.shape) == (1, 3, 84, 108)
    _assert_sr_close(got, want)
    jmodel.opt["tile_process"] = tmodel.opt["tile_process"] = False
    if tile:                                             # tiles with a halo of 4 differ
        whole = tmodel.test(tstate, torch.from_numpy(lq.transpose(0, 3, 1, 2).copy()))
        assert not torch.equal(whole, got)


def test_validation_matches_jax(pair, folders, tmp_path):
    jmodel, jstate, tmodel, tstate = pair
    dopt = {"name": "synthval", "type": "PairedImageDataset", "dataroot_gt": folders["vgt"],
            "dataroot_lq": folders["vlq"], "phase": "val", "scale": 4}
    want = jmodel.validation(jstate, jax_build_dataloader(jax_build_dataset(dopt), dopt), 1)
    tmodel.opt["path"]["visualization"] = str(tmp_path)
    loader = build_dataloader(build_dataset(dopt), dopt)
    got = tmodel.validation(tstate, loader, 7, save_img=True)
    assert set(got) == set(want) == {"psnr", "ssim"}
    assert abs(got["psnr"] - want["psnr"]) < 1e-3 and abs(got["ssim"] - want["ssim"]) < 1e-4
    assert sorted(os.listdir(tmp_path / "synthval")) == ["v0_7.png", "v1_7.png"]
    assert tmodel.best_metric_results["synthval"]["psnr"] == {"val": got["psnr"], "iter": 7}

    class TwoAtOnce:
        dataset = loader.dataset

        def __iter__(self):
            yield {"lq": torch.zeros(2, 3, 8, 8)}

    with pytest.raises(ValueError, match="batch_size_per_gpu=1"):
        tmodel.validation(tstate, TwoAtOnce(), 1)


def test_checkpoints_cross_between_packages(pair, folders, tmp_path):
    """A port-saved net_g_N.pth through JAX's load_params_auto, and the JAX
    package's net_g_N.pkl as the port's pretrain_network_g, give the same SR."""
    jmodel, jstate, tmodel, tstate = pair
    lq = np.random.RandomState(2).rand(1, 16, 16, 3).astype(np.float32)
    lq_t = torch.from_numpy(lq.transpose(0, 3, 1, 2).copy())
    tmodel.save_networks(tstate, str(tmp_path), 5)
    payload = torch.load(tmp_path / "net_g_5.pth")
    assert set(payload) == {"params"}
    tree = load_params_auto(str(tmp_path / "net_g_5.pth"), "params",
                            reference_tree=jstate.params_g)
    assert tree is not None
    _assert_sr_close(tmodel.test(tstate, lq_t), np.asarray(jmodel.test(jstate.replace(
        params_g=tree), lq)))

    jmodel.save_networks(jstate, str(tmp_path), 6)
    opt = eval_opt(folders, str(tmp_path / "net_g_6.pkl"), is_train=False)
    opt["path"]["param_key_g"] = "params"
    loaded = build_model(opt, device="cpu").init_state(seed=9)
    for k, v in tstate.net_g.state_dict().items():
        assert torch.equal(loaded.net_g.state_dict()[k], v), k


def _batches(n):
    rng = np.random.RandomState(3)
    out = []
    for _ in range(n):
        gt = rng.rand(2, 3, 128, 128).astype(np.float32)
        lq = gt.reshape(2, 3, 32, 4, 32, 4).mean(axis=(3, 5))
        mask = (rng.rand(2, 1, 128, 128) < 0.3).astype(np.float32)
        out.append({k: torch.from_numpy(v) for k, v in (("lq", lq), ("gt", gt),
                                                        ("gt_mask", mask))})
    return out


def _tensors(state):
    out = {}
    for name in ("net_g", "net_g_ema", "net_d"):
        out.update({f"{name}.{k}": v for k, v in getattr(state, name).state_dict().items()})
    for name in ("opt_g", "opt_d"):
        for pid, st in getattr(state, name).state_dict()["state"].items():
            out.update({f"{name}.{pid}.{k}": v for k, v in st.items()})
    return out


def test_resume_is_bit_for_bit(folders, tmp_path):
    opt = train_opt(folders)
    batches = _batches(4)
    model = build_model(copy.deepcopy(opt), device="cpu")
    straight = model.init_state()
    for b in batches:
        straight, _ = model.train_step(straight, b)

    first = model.init_state()
    for b in batches[:2]:
        first, _ = model.train_step(first, b)
    random.seed(11)
    model.save_training_state(first, str(tmp_path), epoch=0, current_iter=2)
    draw = (random.random(), np.random.rand(), torch.rand(1))
    assert model.find_latest_state(str(tmp_path)) == 2
    fresh_model = build_model(copy.deepcopy(opt), device="cpu")
    resumed, it = fresh_model.load_training_state(fresh_model.init_state(seed=5), str(tmp_path))
    assert it == 2 and resumed.step == 2
    assert draw == (random.random(), np.random.rand(), torch.rand(1))
    saved = _tensors(first)
    for k, v in _tensors(resumed).items():
        assert torch.equal(v, saved[k]), k
    for b in batches[2:]:
        resumed, _ = fresh_model.train_step(resumed, b)
    want = _tensors(straight)
    assert set(want) == set(_tensors(resumed))
    for k, v in _tensors(resumed).items():
        assert torch.equal(v, want[k]), k
    moved = _tensors(first)
    assert any(not torch.equal(moved[k], want[k]) for k in want if k.startswith("net_g."))


def _run(module, args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_train_and_test_clis_run_on_cpu(folders, tmp_path):
    """python -m of both CLIs with --device cpu: 3 iterations with validation
    and checkpoints, an --auto_resume to 4, and the test CLI on net_g_4.pth;
    without --device and without a card both fail."""
    root = str(tmp_path)
    opt_path = write_json(train_opt(folders), os.path.join(root, "train.json"))
    proc = _run("ssl_tpu_torch.train", ["-opt", opt_path, "--device", "cpu"], root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    exp = os.path.join(root, "experiments", "tiny_cli")
    assert {"net_g_3.pth", "net_d_3.pth"} <= set(os.listdir(os.path.join(exp, "models")))
    assert os.path.exists(os.path.join(exp, "training_states", "3.state"))
    assert sorted(os.listdir(os.path.join(exp, "visualization", "synthval"))) == \
        ["v0_3.png", "v1_3.png"]
    for it in (1, 2, 3):
        assert f"iter:{it:8,d}" in proc.stderr
    assert "Validation synthval: {'psnr'" in proc.stderr

    state = tcli_train.train_pipeline(root, ["-opt", opt_path, "--device", "cpu", "--auto_resume",
                                             "--force_yml", "train:total_iter=4"])
    assert state.step == 4
    assert os.path.exists(os.path.join(exp, "models", "net_g_4.pth"))

    test_path = write_json(eval_opt(folders, os.path.join(exp, "models", "net_g_4.pth")),
                           os.path.join(root, "test.json"))
    proc = _run("ssl_tpu_torch.test", ["-opt", test_path, "--device", "cpu"], root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Results [synthval]: {'psnr'" in proc.stderr
    vis = os.path.join(root, "results", "tiny_test", "visualization", "synthval")
    assert sorted(os.listdir(vis)) == ["v0_tiny_test.png", "v1_tiny_test.png"]

    if not torch.cuda.is_available():
        for cli, path in ((tcli_train.train_pipeline, opt_path),
                          (tcli_test.test_pipeline, test_path)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli(root, ["-opt", path])


def test_test_clis_score_lpips_dists_niqe_like_jax(pair, tmp_path, monkeypatch):
    """One test option file with psnr, ssim, lpips, dists and niqe (crop 4,
    the shipped test YAMLs' metrics) through both packages' test CLIs on the
    same G (the JAX G's .pkl), with seeded official-layout LPIPS / DISTS
    checkpoints by env var; GT of 208 x 112, so that NIQE has two 96-px
    blocks after the crop.  The SR PNGs are equal, so each average is held
    at its metric's tolerance (tests/test_torch_metrics_suite.py): PSNR and
    SSIM rtol 1e-10, NIQE 1e-8, LPIPS 1e-5, DISTS 1e-6 absolute."""
    import cv2
    from ssl_tpu.test import test_pipeline as jax_test_pipeline
    from torch_metric_cases import picture, write_dists, write_lpips
    jmodel, jstate, _, _ = pair
    root = str(tmp_path)
    lpips, alexnet = write_lpips(root, seed=1)
    dists, vgg16 = write_dists(root, seed=2)
    for var, path in (("LPIPS_ALEX_PTH", lpips), ("ALEXNET_PTH", alexnet), ("DISTS_PTH", dists),
                      ("VGG16_PTH", vgg16)):
        monkeypatch.setenv(var, path)
    d = {"vgt": os.path.join(root, "vgt"), "vlq": os.path.join(root, "vlq")}
    for i in range(2):
        gt = picture(208, 112, 60 + i)[..., ::-1]
        for key, img in (("vgt", gt), ("vlq", cv2.resize(gt, (28, 52),
                                                          interpolation=cv2.INTER_AREA))):
            os.makedirs(d[key], exist_ok=True)
            cv2.imwrite(os.path.join(d[key], f"v{i}.png"), img)
    jmodel.save_networks(jstate, root, 6)
    metrics = {name: {"type": f"calculate_{name}", "crop_border": 4}
               for name in ("psnr", "ssim", "lpips", "dists", "niqe")}
    metrics["psnr"]["test_y_channel"] = metrics["ssim"]["test_y_channel"] = True
    results = {}
    for package, run in (("jax", jax_test_pipeline), ("torch", tcli_test.test_pipeline)):
        opt = eval_opt(d, os.path.join(root, "net_g_6.pkl"), name=f"metrics_{package}")
        opt["path"]["param_key_g"] = "params"
        opt["val"]["metrics"] = metrics
        args = ["-opt", write_json(opt, os.path.join(root, f"{package}.json"))]
        results[package] = run(root, args + (["--device", "cpu"] if package == "torch" else []))
    want, got = results["jax"]["synthval"], results["torch"]["synthval"]
    assert set(got) == set(want) == set(metrics)
    for i in range(2):
        pngs = [cv2.imread(os.path.join(root, "results", f"metrics_{p}", "visualization",
                                        "synthval", f"v{i}_metrics_{p}.png")) for p in ("jax", "torch")]
        np.testing.assert_array_equal(*pngs)
    for name, rtol, atol in (("psnr", 1e-10, 0), ("ssim", 1e-10, 0), ("niqe", 1e-8, 0),
                             ("lpips", 1e-5, 0), ("dists", 0, 1e-6)):
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol, err_msg=name)
