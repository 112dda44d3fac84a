"""The port's diffusion inference CLI on the CPU at a tiny config.

``--ckpt`` is the JAX package's params pickle ({'unet', 'structcond',
'null_context'} with numpy leaves).  The port carries it into the weights
that sampling reads (the EMA under the default ``use_ema``), so two
different checkpoints give two different images and the same checkpoint
gives the same image again."""

import os
import pickle

import cv2
import numpy as np
import pytest
import yaml

from ssl_tpu.diffusion.unet import EncoderUNetModelWT as JEnc
from ssl_tpu.diffusion.unet import UNetModelDualcondV2 as JUNet
from ssl_tpu_torch.diffusion import test_cli
from torch_diffusion_cases import CFG, STRUCT, UNET, VAE, seeded_params


def _ckpt(path, seed):
    rng = np.random.RandomState(seed)
    z = rng.randn(1, 16, 16, 4).astype(np.float32)
    t = np.asarray([5], np.int32)
    j_struct = JEnc(**STRUCT)
    sp = seeded_params(j_struct, z, t, seed=seed)
    feats = j_struct.apply({"params": sp}, z, t)
    null = (0.5 * rng.randn(CFG["context_len"], CFG["context_dim"])).astype(np.float32)
    params = {"structcond": sp, "null_context": null,
              "unet": seeded_params(JUNet(**UNET), z, t, null[None], feats, seed=seed + 1)}
    with open(path, "wb") as f:
        pickle.dump(params, f)
    return str(path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    unet = {k: (list(v) if isinstance(v, tuple) else v) for k, v in UNET.items()
            if k not in ("context_dim", "use_flash_attention")}
    struct = {k: (list(v) if isinstance(v, tuple) else v) for k, v in STRUCT.items()
              if k != "use_flash_attention"}
    vae = {k: (list(v) if isinstance(v, tuple) else v) for k, v in VAE.items()
           if k != "use_flash_attention"}
    cfg = {"model": {**CFG, "use_flash_attention": True, "unet": unet, "structcond": struct,
                     "first_stage": vae}}
    (root / "cfg.yml").write_text(yaml.safe_dump(cfg))
    lq = root / "lq"
    lq.mkdir()
    yy, xx = np.mgrid[0:16, 0:16] / 16.0
    img = np.stack([np.sin(5 * yy), xx * yy, np.cos(4 * xx)], -1) * 100 + 120
    cv2.imwrite(str(lq / "a.png"), img.astype(np.uint8))
    return root, [_ckpt(root / f"ckpt{s}.pkl", s) for s in (20, 30)]


def _run(root, ckpt, out, *extra):
    test_cli.main(["--config", str(root / "cfg.yml"), "--ckpt", ckpt, "--init-img",
                   str(root / "lq"), "--outdir", str(root / out), "--ddpm_steps", "2",
                   "--device", "cpu", *extra])
    return cv2.imread(str(root / out / "a.png"), cv2.IMREAD_UNCHANGED)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_cli_samples_with_the_loaded_checkpoint(setup, sampler):
    root, (ckpt_a, ckpt_b) = setup
    a = _run(root, ckpt_a, f"a_{sampler}", "--sampler", sampler, "--colorfix_type", "nofix")
    again = _run(root, ckpt_a, f"a2_{sampler}", "--sampler", sampler, "--colorfix_type", "nofix")
    b = _run(root, ckpt_b, f"b_{sampler}", "--sampler", sampler, "--colorfix_type", "nofix")
    assert a.shape == (64, 64, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, again)
    assert np.abs(a.astype(int) - b.astype(int)).max() > 0


def test_cli_color_fixes_write_images(setup):
    root, (ckpt_a, _) = setup
    for fix in ("adain", "wavelet"):
        out = _run(root, ckpt_a, f"fix_{fix}", "--colorfix_type", fix)
        assert out.shape == (64, 64, 3)


@pytest.mark.parametrize("flag", [["--vqgan_ckpt", "x.pkl"], ["--tp", "2"],
                                  ["--tile_parallel", "--tp", "2"], ["--prompt", "a photo"]])
def test_cli_unported_options_raise(setup, flag):
    """Prompts are not ported; a missing --vqgan_ckpt file raises
    FileNotFoundError (CFW serving: tests/test_torch_cfw.py); --tp 2 needs a
    torchrun world of 2, and --tp with --tile_parallel is refused: each
    raises before any output."""
    root, (ckpt_a, _) = setup
    err, match = ((ValueError, "torchrun") if flag == ["--tp", "2"] else
                  (ValueError, "take one") if "--tile_parallel" in flag else
                  (FileNotFoundError, "x.pkl") if "--vqgan_ckpt" in flag else
                  (NotImplementedError, "ROADMAP"))
    with pytest.raises(err, match=match):
        _run(root, ckpt_a, "unused", *flag)
    assert not os.path.exists(root / "unused")
