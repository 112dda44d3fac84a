"""The port's NIQE, LPIPS and DISTS against ssl_tpu's on the same seeded
inputs and the same checkpoint files.

Tolerances: NIQE rtol 1e-8 (both numpy float64, on the repository's real
pristine parameters), also with ``convert_to='gray'``, where the port
computes cv2's float32 RGB2GRAY without cv2 (equal to cv2 bit for bit on a
width that is a multiple of 8; on a row's last 4-7 pixels an AVX2 build of
cv2 sums in another order, so there the gray values are held within one
float32 ulp).  LPIPS and DISTS rtol 1e-5 (both float32, convolutions in
other orders) at 64^2, on seeded checkpoints in the official layouts
(``tests/torch_metric_cases.py``).  DISTS is 1 - score, its float32 score
near 1 a sum over 1,475 channels, so DISTS near 0.01 carries the score's
rounding at 1: rtol 1e-5 on it is below float32's resolution there, and it
is held at an absolute 1e-6 (DISTS_ATOL; ``scripts/dists_gap_torch.py``
reads at most 3.6e-7, three float32 ulps of 1, over 28 seeded pairs).  The entry points print 6 decimals, held within one unit of the last
(PRINTED_ATOL).  A checkpoint without its backbone is refused by both
packages."""

import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from ssl_tpu.metrics import dists_metric as jdists
from ssl_tpu.metrics import lpips_metric as jlpips
from ssl_tpu.metrics import niqe as jniqe
from ssl_tpu_torch.metrics import calculate_metric
from ssl_tpu_torch.metrics import dists_metric as tdists
from ssl_tpu_torch.metrics import lpips_metric as tlpips
from ssl_tpu_torch.metrics import niqe as tniqe
from ssl_tpu_torch.scripts.metrics import calculate_dists as dists_cli
from ssl_tpu_torch.scripts.metrics import calculate_lpips as lpips_cli
from ssl_tpu_torch.scripts.metrics import calculate_lpips_dists as lpips_dists_cli
from ssl_tpu_torch.scripts.metrics import calculate_niqe_folder as niqe_cli
from ssl_tpu_torch.utils.weight_port import params_from_jax
from torch_metric_cases import assert_same_lines, distorted, picture, write_dists, write_lpips

CLIS = {"calculate_lpips_dists": lpips_dists_cli, "calculate_lpips": lpips_cli,
        "calculate_dists": dists_cli}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the suite runs several test processes on the
    machine's cores, beside JAX's own thread pool in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

DISTS_ATOL = 1e-6
PRINTED_ATOL = 1.5e-6


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("metric_weights"))
    return {"lpips": write_lpips(root, seed=1), "dists": write_dists(root, seed=2)}


@pytest.fixture
def backbones(weights, monkeypatch):
    monkeypatch.setenv("ALEXNET_PTH", weights["lpips"][1])
    monkeypatch.setenv("VGG16_PTH", weights["dists"][1])


@pytest.mark.parametrize("convert_to, crop", [("y", 4), ("y", 0), ("gray", 4)])
def test_niqe_matches_jax_on_real_params(convert_to, crop):
    """200 x 208 pictures (two 96-px blocks a side after the crop), uint8
    and float inputs, HWC and CHW."""
    for seed in range(2):
        img = distorted(picture(200, 208, seed), seed, sigma=6.0)
        want = jniqe.calculate_niqe(img, crop_border=crop, convert_to=convert_to)
        got = tniqe.calculate_niqe(img, crop_border=crop, convert_to=convert_to)
        assert isinstance(got, float) and np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-8)
        f = img.astype(np.float32)
        np.testing.assert_allclose(tniqe.calculate_niqe(f.transpose(2, 0, 1), crop, "CHW",
                                                        convert_to),
                                   jniqe.calculate_niqe(f.transpose(2, 0, 1), crop, "CHW",
                                                        convert_to), rtol=1e-8)
    opt = {"type": "calculate_niqe", "crop_border": crop, "convert_to": convert_to,
           "better": "lower"}
    np.testing.assert_allclose(calculate_metric({"img": img, "img2": img, "device": "cpu"}, opt),
                               want, rtol=1e-8)


def test_rgb_to_gray_is_cv2s():
    import cv2
    rng = np.random.RandomState(0)
    img = (rng.randint(0, 256, (40, 136, 3)) / 255.0).astype(np.float32)
    np.testing.assert_array_equal(tniqe.rgb_to_gray(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    tail = img[:, :133].copy()                  # 16 x 8 + 5: cv2's 4-wide tail on AVX2
    got, want = tniqe.rgb_to_gray(tail), cv2.cvtColor(tail, cv2.COLOR_RGB2GRAY)
    np.testing.assert_array_equal(got[:, :128], want[:, :128])
    assert np.all(np.abs(got - want) <= np.spacing(np.maximum(np.abs(want), np.abs(got))))


def test_niqe_fit_matches_jax(tmp_path):
    import cv2
    for i in range(2):
        cv2.imwrite(str(tmp_path / f"p{i}.png"), picture(200, 200, 10 + i)[..., ::-1])
    mu_t, cov_t = tniqe.fit_niqe_params(str(tmp_path), str(tmp_path / "t.npz"))
    mu_j, cov_j = jniqe.fit_niqe_params(str(tmp_path), str(tmp_path / "j.npz"))
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-8)
    np.testing.assert_allclose(cov_t, cov_j, rtol=1e-8, atol=1e-12)
    img = picture(200, 200, 7)
    np.testing.assert_allclose(
        tniqe.calculate_niqe(img, pris_params_path=str(tmp_path / "t.npz")),
        jniqe.calculate_niqe(img, pris_params_path=str(tmp_path / "j.npz")), rtol=1e-8)


@pytest.mark.parametrize("name", ["lpips", "dists"])
def test_lpips_dists_match_jax(weights, backbones, name):
    """Through the dispatcher with the shipped YAMLs' crop_border 4; identical
    images score 0."""
    jfn = jlpips.calculate_lpips if name == "lpips" else jdists.calculate_dists
    path = weights[name][0]
    opt = {"type": f"calculate_{name}", "crop_border": 4, "weights_path": path}
    a = picture(64, 64, 3)
    for b in (distorted(a, 4), picture(64, 64, 5)):
        want = jfn(b, a, crop_border=4, weights_path=path)
        got = calculate_metric({"img": b, "img2": a, "device": "cpu"}, opt)
        assert isinstance(got, float) and got > 1e-3
        np.testing.assert_allclose(got, want, rtol=1e-5 if name == "lpips" else 0,
                                   atol=DISTS_ATOL if name == "dists" else 0)
    assert abs(calculate_metric({"img": a, "img2": a, "device": "cpu"}, opt)) < 1e-6


def test_lpips_dists_env_paths_and_cache(weights, backbones, monkeypatch):
    """LPIPS_ALEX_PTH / DISTS_PTH stand for weights_path; one model per
    (path, backbone, device), its backbone the file's."""
    monkeypatch.setenv("LPIPS_ALEX_PTH", weights["lpips"][0])
    monkeypatch.setenv("DISTS_PTH", weights["dists"][0])
    a, b = picture(64, 64, 8), picture(64, 64, 9)
    for fn, name in ((tlpips.calculate_lpips, "lpips"), (tdists.calculate_dists, "dists")):
        assert fn(a, b, device="cpu") == fn(a, b, weights_path=weights[name][0], device="cpu")
    model = tlpips.lpips_model(weights["lpips"][0], "cpu")
    assert tlpips.lpips_model(weights["lpips"][0], "cpu") is model
    np.testing.assert_array_equal(model.net.conv1.weight.numpy(),
                                  torch.load(weights["lpips"][1])["features.0.weight"].numpy())
    vgg = tdists.dists_model(weights["dists"][0], "cpu").vgg16
    np.testing.assert_array_equal(vgg.s4_c2.weight.numpy(),
                                  torch.load(weights["dists"][1])["features.28.weight"].numpy())


@pytest.mark.parametrize("name", ["lpips", "dists"])
def test_checkpoint_without_backbone_is_refused(weights, monkeypatch, name):
    monkeypatch.delenv("ALEXNET_PTH", raising=False)
    monkeypatch.delenv("VGG16_PTH", raising=False)
    a = picture(64, 64, 0)
    jfn = jlpips.calculate_lpips if name == "lpips" else jdists.calculate_dists
    tfn = tlpips.calculate_lpips if name == "lpips" else tdists.calculate_dists
    with pytest.raises(ValueError, match="incomplete"):
        jfn(a, a, weights_path=weights[name][0])
    with pytest.raises(ValueError, match="incomplete"):
        tfn(a, a, weights_path=weights[name][0], device="cpu")
    with pytest.raises(FileNotFoundError):
        tfn(a, a, weights_path=str(weights[name][0]) + ".missing", device="cpu")


@pytest.mark.parametrize("family", ["LPIPSAlex", "DISTS"])
def test_params_from_jax_carries_the_jax_tree(weights, backbones, family):
    """The flax tree that ssl_tpu's loaders build from the official files,
    carried into the port's module, equals the port's own load of the files
    tensor for tensor."""
    from ssl_tpu.utils.weight_port import load_torch_state_dict
    name = "lpips" if family == "LPIPSAlex" else "dists"
    jload = jlpips.load_lpips_weights if name == "lpips" else jdists.load_dists_weights
    params: dict = {}
    for path in reversed(weights[name]):                 # backbone, then the metric's file
        params = jload(params, load_torch_state_dict(path, "params"))
    sd = params_from_jax(family, params)
    model = (tlpips.lpips_model if name == "lpips" else tdists.dists_model)(weights[name][0], "cpu")
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)


# ------------------------------------------------------------ entry points
@pytest.fixture(scope="module")
def pair_folders(tmp_path_factory):
    """gt/ and sr/ (sr names with an ``_out`` suffix, one GT without its SR)
    and a NIQE folder with a stray text file, PNG through cv2."""
    import cv2
    root = tmp_path_factory.mktemp("metric_folders")
    for d in ("gt", "sr", "niqe"):
        os.makedirs(root / d)
    for i in range(2):
        gt = picture(64, 64, 40 + i)
        cv2.imwrite(str(root / "gt" / f"im{i}.png"), gt[..., ::-1])
        cv2.imwrite(str(root / "sr" / f"im{i}_out.png"), distorted(gt, i)[..., ::-1])
        cv2.imwrite(str(root / "niqe" / f"n{i}.png"), picture(200, 208, 50 + i)[..., ::-1])
    cv2.imwrite(str(root / "gt" / "im9.png"), picture(64, 64, 49)[..., ::-1])
    (root / "niqe" / "readme.txt").write_text("not an image")
    return root


def _jax_script(name, args, monkeypatch, capsys) -> str:
    """stdout of ``scripts/metrics/<name>.py`` run with ``args``."""
    scripts = os.path.join(REPO, "scripts", "metrics")
    monkeypatch.syspath_prepend(scripts)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + args)
    runpy.run_path(os.path.join(scripts, f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


def test_psnr_ssim_entry_point(pair_folders, monkeypatch, capsys):
    """Through ``python -m`` with cv2 hidden (PNG through utils/png.py): the
    JAX script's lines exactly."""
    args = ["--gt", str(pair_folders / "gt"), "--restored", str(pair_folders / "sr"),
            "--test_y_channel", "--suffix", "_out"]
    want = _jax_script("calculate_psnr_ssim", args, monkeypatch, capsys)
    code = ("import runpy, sys; sys.modules['cv2'] = None; sys.argv = ['x'] + sys.argv[1:]; "
            "runpy.run_module('ssl_tpu_torch.scripts.metrics.calculate_psnr_ssim', "
            "run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code] + args, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout == want and "skip im9.png: no restored file" in want


def test_niqe_folder_entry_point(pair_folders, monkeypatch, capsys):
    args = ["--input", str(pair_folders / "niqe"), "--crop_border", "4"]
    want = _jax_script("calculate_niqe_folder", args, monkeypatch, capsys)
    niqe_cli.main(args)
    assert capsys.readouterr().out == want and len(want.splitlines()) == 3


@pytest.mark.parametrize("script, metric", [("calculate_lpips_dists", "lpips"),
                                            ("calculate_lpips", "lpips"),
                                            ("calculate_dists", "dists")])
def test_lpips_dists_entry_points(weights, backbones, pair_folders, monkeypatch, capsys, script,
                                  metric):
    """Each entry point against the JAX script of its name: the same lines,
    the values within one unit of the sixth printed decimal."""
    args = ["--gt", str(pair_folders / "gt"), "--restored", str(pair_folders / "sr"),
            "--suffix", "_out", "--weights", weights[metric][0]]
    if script == "calculate_lpips_dists":
        args = ["--metric", metric] + args
    want = _jax_script(script, args, monkeypatch, capsys)
    CLIS[script].main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert f"Average {metric.upper()}: " in got and "skip im9.png" in got
    assert_same_lines(got, want, atol=PRINTED_ATOL)
