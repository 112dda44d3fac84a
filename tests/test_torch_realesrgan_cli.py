"""The RealESRGAN-SSL train and test CLIs of the port on the CPU
(``--device cpu``, ``num_worker_per_gpu: 0``), against themselves and
against ssl_tpu's CLIs.

* 2 iterations, then ``--auto_resume`` to 4, end in the same training
  state as 4 straight iterations, bit for bit: nets, optimizers, the pool's
  buffers and pointer, and the degradation's generators (4 GT images at
  batch 2: each epoch is 2 iterations, so the resumed run opens epoch 1 as
  the straight run does; ``queue_size`` 4: iterations 3-4 draw from the
  full pool).
* Iteration 1's l_pix, l_selfsim and l_selfsim_kl equal the JAX CLI's
  within rtol 1e-4 (the train step's tolerance), with the same G ``.pth``,
  no D, and the port's draws replaced by the JAX step's, replayed from its
  ``state.rng`` (``tests/torch_realesrgan_cases.py``): both loaders draw the
  same crops, flips and kernels from one seed.
* The test CLI on a BlindLR-style ``MultiLROneGTDataset`` folder gives the
  JAX test CLI's PSNR within 1e-3 dB and SSIM within 1e-4 (an SR pixel near
  .5 may round the other way)."""

import copy
import os

import cv2
import numpy as np
import pytest
import torch
from scipy.io import savemat

import ssl_tpu.test as jcli_test
import ssl_tpu.train as jcli_train
import ssl_tpu_torch.test as tcli_test
import ssl_tpu_torch.train as tcli_train
from ssl_tpu.ops.degrade_jax import DegradeJaxConfig
from ssl_tpu.utils import logger as jlogger
from ssl_tpu_torch.archs import RRDBNet
from ssl_tpu_torch.models.realesrganssl_model import RealESRGANSSLModel
from ssl_tpu_torch.ops.edge_mask import edge_mask_np
from ssl_tpu_torch.utils import logger as tlogger
from torch_cli_cases import write_json
from torch_realesrgan_cases import D_OPT, DEGRADE, G_OPT, SSL_OPT, jax_step_draws

GT_IMG, CROP, BATCH, QSIZE = 48, 32, 2, 4
METRICS = {"psnr": {"type": "calculate_psnr", "crop_border": 4, "test_y_channel": True},
           "ssim": {"type": "calculate_ssim", "crop_border": 4, "test_y_channel": True}}


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread (the suite runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _picture(h, w, rng):
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([np.sin(7 * yy) * 0.3 + 0.5, xx * yy + 0.2, np.cos(5 * (xx + yy)) * 0.3 + 0.5],
                   -1) + rng.randn(h, w, 3) * 0.03
    img[h // 5:h // 2, w // 4:w // 2] = 0.9
    img[2 * h // 3:, 3 * w // 5:] = 0.1
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """gt/ and mask/ (4 GT PNGs of 48^2 and their .mat masks); tgt/ and
    blind/<variant>/ (2 GT of 64 x 48, LQ of 16 x 12 in two variants)."""
    root = tmp_path_factory.mktemp("realesrgan_cli")
    d = {k: str(root / k) for k in ("gt", "mask", "tgt", "blind")}
    for p in d.values():
        os.makedirs(p)
    rng = np.random.RandomState(1)
    for i in range(4):
        img = _picture(GT_IMG, GT_IMG, rng)
        cv2.imwrite(os.path.join(d["gt"], f"{i:04d}.png"), img)
        savemat(os.path.join(d["mask"], f"{i:04d}.mat"),
                {"mat": edge_mask_np(img[..., ::-1], 20.0).astype(np.float64)})
    for i in range(2):
        img = _picture(64, 48, rng)
        cv2.imwrite(os.path.join(d["tgt"], f"t{i}.png"), img)
        for variant, interp in (("area", cv2.INTER_AREA), ("cubic", cv2.INTER_CUBIC)):
            os.makedirs(os.path.join(d["blind"], variant), exist_ok=True)
            cv2.imwrite(os.path.join(d["blind"], variant, f"t{i}.png"),
                        cv2.resize(img, (12, 16), interpolation=interp))
    return d


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    g = RRDBNet(**{k: v for k, v in G_OPT.items() if k != "type"})
    g.reset_parameters(torch.Generator().manual_seed(3))
    path = str(tmp_path_factory.mktemp("weights") / "g.pth")
    torch.save({"params": g.state_dict(), "params_ema": g.state_dict()}, path)
    return path


def _train_opt(d, name, total_iter, d_net=True, **extra):
    opt = {
        "name": name, "model_type": "RealESRGANSSLModel", "scale": 4, "num_devices": 1,
        "manual_seed": 0, "queue_size": QSIZE, **DEGRADE,
        "datasets": {"train": {
            "name": "synth", "type": "MyRealESRGANImageMaskDataset", "dataroot_gt": d["gt"],
            "dataroot_gt_mask": d["mask"], "crop_pre": CROP, "gt_size": CROP,
            "use_hflip": True, "use_rot": True, "num_worker_per_gpu": 0,
            "batch_size_per_gpu": BATCH, "dataset_enlarge_ratio": 1}},
        "network_g": dict(G_OPT), "path": {"pretrain_network_g": None},
        "ssl_setting": dict(SSL_OPT),
        "train": {
            "ema_decay": 0.999,
            "optim_g": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "optim_d": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [400000], "gamma": 0.5},
            "total_iter": total_iter, "warmup_iter": -1,
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0, "reduction": "mean"},
            "selfsim_opt": {"type": "L1Loss", "loss_weight": 1e3, "reduction": "mean"},
            "selfsim1_opt": {"type": "KLDistanceLoss", "loss_weight": 1e3, "reduction": "mean",
                             "softmax": False},
            "gan_opt": {"type": "GANLoss", "gan_type": "vanilla", "real_label_val": 1.0,
                        "fake_label_val": 0.0, "loss_weight": 1e-1},
            "net_d_iters": 1, "net_d_init_iters": 0},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 100, "use_tb_logger": False},
    }
    if d_net:
        opt["network_d"] = dict(D_OPT)
    else:
        del opt["train"]["optim_d"], opt["train"]["gan_opt"]
    opt.update(extra)
    return opt


def _assert_same(a, b, where="state"):
    """Nested dicts / lists / tensors equal bit for bit."""
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), (where, sorted(set(a) ^ set(b)))
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def test_resume_2_plus_2_equals_4_bit_for_bit(folders, tmp_path):
    root = str(tmp_path)
    straight = write_json(_train_opt(folders, "straight", 4), os.path.join(root, "straight.json"))
    split = write_json(_train_opt(folders, "split", 2), os.path.join(root, "split.json"))
    state = tcli_train.train_pipeline(root, ["-opt", straight, "--device", "cpu"])
    assert state.step == 4 and state.extra["queue_ptr"] == QSIZE
    first = tcli_train.train_pipeline(root, ["-opt", split, "--device", "cpu"])
    assert first.step == 2 and first.extra["queue_ptr"] == QSIZE
    resumed = tcli_train.train_pipeline(root, ["-opt", split, "--device", "cpu", "--auto_resume",
                                               "--force_yml", "train:total_iter=4"])
    assert resumed.step == 4
    want, got = (torch.load(os.path.join(root, "experiments", name, "training_states",
                                         "4.state"), weights_only=True)
                 for name in ("straight", "split"))
    assert set(want["extra"]) == {"host_gen", "dev_gen", "queue_ptr", "queue_lq", "queue_gt",
                                  "queue_gt_usm", "queue_gt_mask"}
    _assert_same(got, want)
    moved = torch.load(os.path.join(root, "experiments", "split", "training_states", "2.state"),
                       weights_only=True)
    assert not torch.equal(moved["extra"]["queue_gt"], want["extra"]["queue_gt"])


def _recording(monkeypatch, logger_cls):
    seen = []
    call = logger_cls.__call__

    def record(self, log_vars):
        seen.append(dict(log_vars))
        return call(self, log_vars)
    monkeypatch.setattr(logger_cls, "__call__", record)
    return seen


def test_first_iteration_losses_match_jax_cli(folders, weights, tmp_path, monkeypatch):
    root = str(tmp_path)
    runs = {}
    for name, cli, logger_cls, extra in (
            ("torch", tcli_train, tlogger.MessageLogger, ["--device", "cpu"]),
            ("jax", jcli_train, jlogger.MessageLogger, [])):
        opt = _train_opt(folders, f"first_{name}", 1, d_net=False,
                         path={"pretrain_network_g": weights, "param_key_g": "params"})
        if name == "torch":
            jcfg = DegradeJaxConfig(**{k: tuple(v) if isinstance(v, list) else v
                                       for k, v in opt.items() if k in DegradeJaxConfig._fields})
            import jax

            def jax_draws(self, state, batch):
                return jax_step_draws(jax.random.PRNGKey(opt["manual_seed"]), jcfg, BATCH, CROP,
                                      QSIZE, False)
            monkeypatch.setattr(RealESRGANSSLModel, "draws", jax_draws)
        seen = _recording(monkeypatch, logger_cls)
        cli.train_pipeline(root, ["-opt", write_json(opt, os.path.join(root, f"{name}.json"))]
                           + extra)
        assert [s["iter"] for s in seen] == [1]
        runs[name] = seen[0]
        monkeypatch.undo()
    for k in ("l_pix", "l_selfsim", "l_selfsim_kl"):
        assert np.isfinite(runs["torch"][k]) and runs["torch"][k] > 0, k
        np.testing.assert_allclose(runs["torch"][k], runs["jax"][k], rtol=1e-4, err_msg=k)


def test_test_cli_on_blind_sets_matches_jax(folders, weights, tmp_path):
    root = str(tmp_path)
    opt = {"name": "blind_test", "model_type": "RealESRGANSSLModel", "scale": 4,
           "num_devices": 1, "manual_seed": 0, "tile_process": False,
           "datasets": {"test_1": {"name": "Blind", "type": "MultiLROneGTDataset",
                                   "dataroot_gt": folders["tgt"],
                                   "dataroot_lq": folders["blind"],
                                   "io_backend": {"type": "disk"}}},
           "network_g": dict(G_OPT),
           "path": {"pretrain_network_g": weights, "param_key_g": "params_ema"},
           "val": {"save_img": True, "metrics": METRICS}}
    path = write_json(opt, os.path.join(root, "test.json"))
    got = tcli_test.test_pipeline(root, ["-opt", path, "--device", "cpu"])["Blind"]
    jopt = copy.deepcopy(opt)
    jopt["name"] = "blind_test_jax"
    want = jcli_test.test_pipeline(root, ["-opt", write_json(jopt, os.path.join(root, "j.json"))])
    want = want["Blind"]
    assert set(got) == {"psnr", "ssim"} and all(np.isfinite(v) for v in got.values())
    assert abs(got["psnr"] - want["psnr"]) < 1e-3 and abs(got["ssim"] - want["ssim"]) < 1e-4
    vis = os.path.join(root, "results", "blind_test", "visualization", "Blind")
    assert sorted(os.listdir(vis)) == ["t0_blind_test.png", "t1_blind_test.png"]
