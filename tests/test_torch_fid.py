"""The port's FID against ssl_tpu's: the InceptionV3 pool3 features of the
same pt_inception-layout checkpoint (seeded, ``tests/torch_metric_cases.py``)
through each package's loader, the Frechet distance, the weight carry, and
the two FID entry points.

Tolerances: pool3 features within a relative L2 of 1e-5 (float32,
convolutions in other orders, 94 of them deep); the Frechet distance on
shared statistics rtol 1e-8 (both scipy float64).  The entry points' mean
against the JAX script's ``folder_features`` of the same folder within a
relative L2 of 1e-5, their covariance within 1e-4 (four images: the
covariance is made of their deviations from the mean, about 2% of the
features' norm here, so the features' float32 error shows there some 50
times larger).  The entry points hand their statistics to
``calculate_fid_from_stats`` (held above) through a spy: its 2048 x 2048
matrix square root takes 10-20 s on a CPU.
The port's cv2-free uint8 INTER_LINEAR resize equals cv2's bit for bit."""

import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from ssl_tpu.metrics import fid as jfid
from ssl_tpu.utils.weight_port import convert_fid_inception, load_torch_state_dict
from ssl_tpu_torch.metrics import fid as tfid
from ssl_tpu_torch.scripts.metrics import calculate_fid_folder as tcli
from ssl_tpu_torch.scripts.metrics import calculate_fid_stats_from_GT as tstats
from ssl_tpu_torch.utils.weight_port import params_from_jax
from torch_metric_cases import distorted, picture, write_fid_inception

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the suite runs several test processes on the
    machine's cores, beside JAX's own thread pool in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def inception(tmp_path_factory):
    """(checkpoint path, the JAX module and variables from its loader)."""
    path = write_fid_inception(str(tmp_path_factory.mktemp("fid") / "pt_inception.pth"), seed=0)
    params, stats = convert_fid_inception(load_torch_state_dict(path))
    return path, jfid.InceptionV3FID(), {"params": params, "batch_stats": stats}


def test_pool3_features_match_jax(inception):
    """Batch 2 at 72 x 88: both resize to 299 inside (F.interpolate bilinear)."""
    path, jmodel, variables = inception
    x = np.stack([picture(72, 88, s) for s in range(2)]).astype(np.float32) / 255.0
    want = np.asarray(jax.jit(jmodel.apply)(variables, x))
    model = tfid.load_inception(path, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert got.shape == (2, 2048) and np.isfinite(got).all()
    assert rel_l2(got, want) < 1e-5
    assert rel_l2(got[0], got[1]) > 1e-3


def test_frechet_distance_matches_jax():
    rng = np.random.RandomState(0)
    f1, f2 = rng.randn(200, 16), rng.randn(150, 16) * 1.3 + 0.4
    np.testing.assert_allclose(tfid.calculate_fid(feats1=f1, feats2=f2),
                               jfid.calculate_fid(feats1=f1, feats2=f2), rtol=1e-8)
    mu, sigma = tfid.stats_from_features(f1)
    assert abs(tfid.calculate_fid_from_stats(mu, sigma, mu, sigma)) < 1e-6


def test_params_from_jax_inverts_the_jax_loader(inception):
    """The flax tree of ssl_tpu's converter, carried back, is the file's
    tensors; a file without every conv is refused."""
    path, _, variables = inception
    sd = params_from_jax("InceptionV3FID", variables["params"], variables["batch_stats"])
    file = torch.load(path)
    assert set(sd) == {k for k in file if not k.startswith("fc.")}
    for k, v in sd.items():
        assert torch.equal(v, file[k]), k
    del file["Mixed_7c.branch_pool.conv.weight"]
    torch.save(file, path + ".cut")
    with pytest.raises(ValueError, match="incomplete"):
        tfid.load_inception(path + ".cut", device="cpu")


def test_resize_linear_u8_is_cv2s():
    import cv2
    rng = np.random.RandomState(1)
    for h, w in ((72, 88), (350, 420), (299, 299), (37, 500), (598, 598)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        np.testing.assert_array_equal(tcli.resize_linear_u8(img, 299, 299),
                                      cv2.resize(img, (299, 299), interpolation=cv2.INTER_LINEAR))


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    import cv2
    root = tmp_path_factory.mktemp("fid_folders")
    for d in ("gt", "sr"):
        os.makedirs(root / d)
    for i in range(4):
        gt = picture(96 + 8 * i, 120, 20 + i)
        cv2.imwrite(str(root / "gt" / f"im{i}.png"), gt[..., ::-1])
        cv2.imwrite(str(root / "sr" / f"im{i}.png"), distorted(gt, i)[..., ::-1])
    return root


@pytest.fixture(scope="module")
def jax_stats(inception, folders):
    """mu / sigma of each folder through the JAX script's folder_features."""
    sys.path.insert(0, os.path.join(REPO, "scripts", "metrics"))
    try:
        folder_features = runpy.run_path(os.path.join(REPO, "scripts", "metrics",
                                                      "calculate_fid_folder.py"))["folder_features"]
    finally:
        sys.path.remove(os.path.join(REPO, "scripts", "metrics"))
    _, jmodel, variables = inception
    return {d: jfid.stats_from_features(folder_features(str(folders / d), jmodel, variables,
                                                        batch=2)) for d in ("gt", "sr")}


def _hold_stats(npz, want):
    d = np.load(npz)
    assert rel_l2(d["mu"], want[0]) < 1e-5 and rel_l2(d["sigma"], want[1]) < 1e-4


def test_fid_folder_entry_point(inception, folders, jax_stats, monkeypatch, capsys):
    """--gt with --save_stats, then --gt_stats, with cv2 hidden (the port's
    own resize), batches of 2 and 3."""
    monkeypatch.setenv("FID_INCEPTION_PTH", inception[0])
    monkeypatch.setitem(sys.modules, "cv2", None)
    calls = []

    def spy(*stats):
        calls.append(stats)
        return 12.345678

    monkeypatch.setattr(tcli, "calculate_fid_from_stats", spy)
    sr_stats, gt_stats = str(folders / "sr.npz"), str(folders / "gt.npz")
    tcli.main(["--restored", str(folders / "sr"), "--gt", str(folders / "gt"), "--batch", "2",
               "--save_stats", sr_stats, "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == [f"saved stats to {sr_stats}", "FID: 12.3457"]
    _hold_stats(sr_stats, jax_stats["sr"])
    mu_r, sigma_r, mu_g, sigma_g = calls[0]
    saved = np.load(sr_stats)
    assert np.array_equal(mu_r, saved["mu"]) and np.array_equal(sigma_r, saved["sigma"])
    assert rel_l2(mu_g, jax_stats["gt"][0]) < 1e-5 and rel_l2(sigma_g, jax_stats["gt"][1]) < 1e-4
    np.savez(gt_stats, mu=jax_stats["gt"][0], sigma=jax_stats["gt"][1])
    tcli.main(["--restored", str(folders / "sr"), "--gt_stats", gt_stats, "--batch", "3",
               "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == ["FID: 12.3457"]
    assert np.array_equal(calls[1][0], mu_r) and np.array_equal(calls[1][3], jax_stats["gt"][1])


def test_fid_stats_from_gt_entry_point(inception, folders, jax_stats, monkeypatch, capsys):
    monkeypatch.setenv("FID_INCEPTION_PTH", inception[0])
    out = str(folders / "gt_stats.npz")
    tstats.main(["--gt", str(folders / "gt"), "--out", out, "--device", "cpu"])
    assert capsys.readouterr().out.strip() == f"saved FID stats for 4 images to {out}"
    _hold_stats(out, jax_stats["gt"])


def test_missing_weights_are_refused(inception, folders, tmp_path, monkeypatch, capsys):
    """Without FID_INCEPTION_PTH, or with it naming no file, the loader and
    both entry points raise instead of scoring with random weights (the JAX
    package's loader falls back to them; ROADMAP.md §3)."""
    for env in (None, inception[0] + ".missing"):
        if env is None:
            monkeypatch.delenv("FID_INCEPTION_PTH", raising=False)
        else:
            monkeypatch.setenv("FID_INCEPTION_PTH", env)
        with pytest.raises(FileNotFoundError, match="FID_INCEPTION_PTH"):
            tfid.load_inception(device="cpu")
        with pytest.raises(FileNotFoundError, match="FID_INCEPTION_PTH"):
            tcli.main(["--restored", str(folders / "sr"), "--gt", str(folders / "gt"),
                       "--device", "cpu"])
        with pytest.raises(FileNotFoundError, match="FID_INCEPTION_PTH"):
            tstats.main(["--gt", str(folders / "gt"), "--out", str(tmp_path / "s.npz"),
                         "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="missing"):
        tfid.load_inception(inception[0] + ".missing", device="cpu")
    assert capsys.readouterr().out == "" and not os.path.exists(tmp_path / "s.npz")
