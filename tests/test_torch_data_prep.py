"""The port's data-preparation entry points against the JAX package's
scripts (scripts/data_preparation/*.py), on seeded PNG fixtures.

Holds: the Matlab-bicubic outputs (``generate_bicubic_lr`` bicubic, with
``--mod``, ``--gt_output`` and ``--list``; ``generate_multiscale_img``) equal
pixel for pixel; the random modes (``generate_bicubic_lr --mode
realesrgan|bsrgan``, ``generate_realesrgan_bsrgan_lr`` on the shipped
option file) with the JAX script's draws seeded alike (its degrader drawing
from the global streams it seeds, and in both packages a deterministic
Poisson, tests/torch_host_degrade_cases.py: numpy's Poisson sampler walks
its stream, so a rate one ulp apart would shift every later draw): the same
branch for each image, and the LR and its bicubic SR within one uint8 level
on at most 0.1% of values (the host degrader's bound; the Poisson noise's
scale is 2^ceil(log2(the image's distinct levels)), as in the reference, so
an LR with few distinct levels can double it over one value rounded the
other way: the generator's fixtures are large enough that each LR holds
more than 128 levels, as a photograph's does); ``back_projection``
in both modes within one level on at most 0.01% of values; and each port
script again with ``cv2`` hidden, giving the same pixels, except where the
BSRGAN chain ran: there the port's own float32 resize equals cv2's only to
float32 rounding (tests/test_torch_bsrgan_degradation.py), and a value that
rounds the other way before one of the chain's JPEG round trips moves its
8 x 8 block by a few levels, so those LR (and their SR) are held to a PSNR
of NOCV2_BSRGAN_PSNR dB against the cv2 run's instead."""

import importlib.util
import json
import os
import random
import sys

import numpy as np
import pytest
import yaml

from ssl_tpu_torch.scripts import (back_projection, generate_bicubic_lr,
                                   generate_multiscale_img, generate_realesrgan_bsrgan_lr)
from ssl_tpu_torch.utils.png import decode_png, encode_png

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_host_degrade_cases import check_levels, det_poisson  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED_GENERATE = os.path.join(REPO, "options", "generate", "generate_RealESRGAN+BSRGAN_LR.yml")
BP_SHARE = 1e-4
NOCV2_BSRGAN_PSNR = 40.0


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _hold_nocv2(got_u8, want_u8, bsrgan):
    """A cv2-less run's output against the cv2 run's (see the module doc)."""
    if not bsrgan:
        check_levels(got_u8 / 255.0, want_u8 / 255.0)
        return
    assert got_u8.shape == want_u8.shape
    assert _psnr(got_u8, want_u8) >= NOCV2_BSRGAN_PSNR, _psnr(got_u8, want_u8)


def _jax_script(name):
    path = os.path.join(REPO, "scripts", "data_preparation", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_prep_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(monkeypatch, name, argv):
    mod = _jax_script(name)
    monkeypatch.setattr(sys, "argv", [name] + [str(a) for a in argv])
    mod.main()


def _picture(rng, h, w):
    """Smooth colour fields with a sharp block and light noise, uint8 BGR."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    f = rng.rand(3, 3) * 6 + 1
    img = np.stack([0.5 + 0.3 * np.sin(f[c, 0] * yy + f[c, 1] * xx + f[c, 2])
                    for c in range(3)], -1)
    y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
    img[y0:y0 + h // 3, x0:x0 + w // 3] = rng.rand(3)
    img = img + 0.03 * rng.randn(h, w, 3)
    return np.clip(np.round(img * 255), 0, 255).astype(np.uint8)


def _write(path, img):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _read(path):
    with open(path, "rb") as f:
        return decode_png(f.read(), "unchanged")


@pytest.fixture(scope="module")
def hr(tmp_path_factory):
    """Four HR PNGs (sizes no multiple of 12, one with a sub-folder) and a
    meta list naming the sub-folder and one file."""
    root = tmp_path_factory.mktemp("hr")
    rng = np.random.RandomState(7)
    for name, (h, w) in {"a.png": (65, 51), "b.png": (52, 77), "c.png": (48, 64),
                         "sub/d.png": (50, 62)}.items():
        _write(str(root / "in" / name), _picture(rng, h, w))
    (root / "meta.txt").write_text("sub\nb.png\n")
    return root


def _same_pixels(dir_a, dir_b, names):
    for name in names:
        a, b = _read(os.path.join(dir_a, name)), _read(os.path.join(dir_b, name))
        assert a.shape == b.shape and np.array_equal(a, b), name


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("case", ["mod12_gt", "mod0_scale2", "list"])
def test_bicubic_lr_equals_jax(hr, tmp_path, monkeypatch, case):
    args = {"mod12_gt": ["--mod", 12, "--gt_output"], "mod0_scale2": ["--mod", 0, "--scale", 2],
            "list": ["--list", hr / "meta.txt"]}[case]
    out = {}
    for side in ("jax", "port", "port_nocv2"):
        argv = ["--input", hr / "in", "--output", tmp_path / side / "lr"] + args
        if case == "mod12_gt":
            argv.append(tmp_path / side / "gt")
        if side == "jax":
            _run_jax(monkeypatch, "generate_bicubic_lr", argv)
        else:
            with monkeypatch.context() as m:
                if side == "port_nocv2":
                    m.setitem(sys.modules, "cv2", None)
                generate_bicubic_lr.main([str(a) for a in argv])
        out[side] = tmp_path / side
    names = _files(out["jax"])
    assert names == _files(out["port"]) == _files(out["port_nocv2"])
    assert len(names) == (6 if case == "mod12_gt" else 3 if case == "mod0_scale2" else 2)
    for side in ("port", "port_nocv2"):
        _same_pixels(out["jax"], out[side], names)
    if case == "mod12_gt":
        assert _read(str(out["port"] / "gt" / "a.png")).shape == (60, 48, 3)
        assert _read(str(out["port"] / "lr" / "a.png")).shape == (15, 12, 3)


def test_multiscale_img_equals_jax(hr, tmp_path, monkeypatch):
    flat = tmp_path / "flat"
    os.makedirs(flat)
    for name in ("a.png", "c.png"):
        _write(str(flat / name), _read(str(hr / "in" / name)))
    _run_jax(monkeypatch, "generate_multiscale_img", ["--input", flat, "--output", tmp_path / "j"])
    generate_multiscale_img.main(["--input", str(flat), "--output", str(tmp_path / "p")])
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        generate_multiscale_img.main(["--input", str(flat), "--output", str(tmp_path / "q")])
    names = _files(tmp_path / "j")
    assert len(names) == 8 and names == _files(tmp_path / "p") == _files(tmp_path / "q")
    _same_pixels(tmp_path / "j", tmp_path / "p", names)
    _same_pixels(tmp_path / "j", tmp_path / "q", names)


def _seed_jax_degrader(monkeypatch):
    """The JAX degrader draws from the global streams (which the JAX scripts
    seed or the test seeds) and both packages' plans take ``det_poisson``."""
    import ssl_tpu.data.realesr_degradation as jrd
    import ssl_tpu_torch.data.realesr_degradation as trd

    class JDegrader(jrd.RealESRGANDegrader):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.rng, self.pyrng = np.random, random

    for cls in (JDegrader, trd.RealESRGANDegrader):
        draw = cls.draw_plan

        def plan(self, b, _draw=draw):
            p = _draw(self, b)
            for stage in ("noise1", "noise2"):
                if stage in p:
                    p[stage]["poisson"] = det_poisson
            return p
        monkeypatch.setattr(cls, "draw_plan", plan)
    monkeypatch.setattr(jrd, "RealESRGANDegrader", JDegrader)


@pytest.mark.parametrize("mode", ["realesrgan", "bsrgan"])
def test_random_lr_modes_match_jax(hr, tmp_path, monkeypatch, mode):
    """generate_bicubic_lr's random modes, the JAX script on the global
    streams seeded as the port's generators are."""
    _seed_jax_degrader(monkeypatch)
    argv = ["--input", str(hr / "in"), "--mode", mode, "--mod", "4"]
    random.seed(5)
    np.random.seed(5)
    _run_jax(monkeypatch, "generate_bicubic_lr", argv + ["--output", tmp_path / "j"])
    generate_bicubic_lr.main(argv + ["--output", str(tmp_path / "p")],
                             random.Random(5), np.random.RandomState(5))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        generate_bicubic_lr.main(argv + ["--output", str(tmp_path / "q")],
                                 random.Random(5), np.random.RandomState(5))
    names = _files(tmp_path / "j")
    assert len(names) == 3 and names == _files(tmp_path / "p") == _files(tmp_path / "q")
    for name in names:
        want = _read(str(tmp_path / "j" / name))
        check_levels(_read(str(tmp_path / "p" / name)) / 255.0, want / 255.0)
        _hold_nocv2(_read(str(tmp_path / "q" / name)), _read(str(tmp_path / "p" / name)),
                    mode == "bsrgan")


def _generate_opt(tmp_path, root):
    """The shipped generate options with the fixture folder as its one
    dataset (the YAML's own seed, scale and degradation ranges)."""
    with open(SHIPPED_GENERATE) as f:
        opt = yaml.safe_load(f)
    opt["datasets"] = {"fixtures": {"dataroot": str(root)}}
    path = tmp_path / "generate.yml"
    path.write_text(yaml.safe_dump(opt))
    return path


def test_realesrgan_bsrgan_lr_matches_jax(hr, tmp_path, monkeypatch, capsys):
    """The shipped option file over five HR images: the same branch for
    each (both branches taken), LR and bicubic SR within the bound."""
    flat = tmp_path / "flat"
    rng = np.random.RandomState(3)
    for i in range(5):
        _write(str(flat / f"im{i}.png"), _picture(rng, 128 + 8 * i, 112))
    opt_path = _generate_opt(tmp_path, flat)
    _seed_jax_degrader(monkeypatch)
    out = {}
    for side in ("jax", "port", "port_nocv2"):
        argv = ["--param_path", str(opt_path), "--save_LR_path", str(tmp_path / side / "lr"),
                "--save_bicubicSR_path", str(tmp_path / side / "sr")]
        capsys.readouterr()
        if side == "jax":
            _run_jax(monkeypatch, "generate_realesrgan_bsrgan_lr", argv)
            out[side] = [ln.split(": ")[1].split(" ")[0] for ln in capsys.readouterr().out
                         .splitlines() if ln.startswith("  im")]
        else:
            if side == "port_nocv2":                   # a .json option file needs no yaml
                json_path = tmp_path / "generate.json"
                json_path.write_text(json.dumps(yaml.safe_load(opt_path.read_text())))
                argv[1] = str(json_path)
            with monkeypatch.context() as m:
                if side == "port_nocv2":
                    m.setitem(sys.modules, "cv2", None)
                    m.setitem(sys.modules, "yaml", None)
                out[side] = [tag for _, tag in generate_realesrgan_bsrgan_lr.main(argv)]
    assert out["jax"] == out["port"] == out["port_nocv2"]
    assert set(out["port"]) == {"realesrgan", "bsrgan"}, out["port"]
    for sub in ("lr", "sr"):
        names = _files(tmp_path / "jax" / sub)
        assert len(names) == 5
        for side in ("port", "port_nocv2"):
            assert _files(tmp_path / side / sub) == names
        for name, tag in zip(names, out["port"]):
            got, want = (_read(str(tmp_path / side / sub / name))
                         for side in ("port", "jax"))
            check_levels(got / 255.0, want / 255.0)
            _hold_nocv2(_read(str(tmp_path / "port_nocv2" / sub / name)), got, tag == "bsrgan")


@pytest.mark.parametrize("mode", ["bp", "reverse_filter"])
def test_back_projection_matches_jax(tmp_path, monkeypatch, mode):
    rng = np.random.RandomState(11)
    for i in range(2):
        sr = _picture(rng, 40, 48)
        lr = _picture(rng, 10, 12)
        _write(str(tmp_path / "pre" / f"x{i}.png"), sr)
        _write(str(tmp_path / "lr" / f"x{i}.png"), lr)
    argv = ["--lr", tmp_path / "lr", "--pre", tmp_path / "pre", "--mode", mode, "--iters", 3]
    _run_jax(monkeypatch, "back_projection", argv + ["--out", tmp_path / "j"])
    back_projection.main([str(a) for a in argv + ["--out", tmp_path / "p"]])
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        back_projection.main([str(a) for a in argv + ["--out", tmp_path / "q"]])
    for name in ("x0.png", "x1.png"):
        want = _read(str(tmp_path / "j" / name)).astype(np.int64)
        for side in ("p", "q"):
            got = _read(str(tmp_path / side / name)).astype(np.int64)
            d = np.abs(got - want)
            assert got.shape == want.shape and d.max() <= 1 and (d > 0).mean() <= BP_SHARE, \
                (side, d.max(), (d > 0).mean())
