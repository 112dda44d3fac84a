"""Seeded checkpoints in the official layouts of the metric suite's weights,
and test pictures.  Imports no JAX: ``chip_smoke.py`` writes its full-width
files with these too.

- ``write_lpips``: a torchvision AlexNet state dict (``features.N``) and the
  lpips package's ``alex.pth`` (the ``lin{i}.model.1.weight`` heads only);
- ``write_dists``: a torchvision VGG16 state dict and the DISTS
  ``weights.pt`` (alpha / beta (1, 1475, 1, 1) only);
- ``write_fid_inception``: pt_inception-2015-12-05's keys (torchvision's
  inception names, the classifier ``fc`` included);
- ``write_clip_rn50``: OpenAI CLIP's RN50 keys under ``state_dict``;
- ``write_merges``: a small BPE merges file.

Weights are normal with He's std sqrt(2 / fan_in), so that activations
keep their scale through the ReLU nets' depth; batch norms carry small
random statistics, so that they do work."""

from __future__ import annotations

import os

import numpy as np
import torch

ALEX_CONVS = ((0, 64, 3, 11), (3, 192, 64, 5), (6, 384, 192, 3), (8, 256, 384, 3),
              (10, 256, 256, 3))
VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# RN50's widths (OpenAI CLIP): visual width 64, layers (3, 4, 6, 3), embed
# 1024; text width 512, 12 layers, vocab 49,408
RN50 = {"width": 64, "layers": (3, 4, 6, 3), "embed": 1024, "twidth": 512, "tlayers": 12,
        "vocab": 49408}


def picture(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth colour field with blocks, edges and noise: HWC RGB uint8."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([np.sin(9 * yy + seed) * 0.3 + 0.5, xx * yy + 0.2,
                    np.cos(6 * (xx + yy)) * 0.3 + 0.5], -1)
    img[h // 5:h // 2, w // 4:w // 2] = 0.85
    img[2 * h // 3:, 3 * w // 5:] = 0.12
    img = img + rng.randn(h, w, 3) * 0.04
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


def distorted(img: np.ndarray, seed: int, sigma: float = 12.0) -> np.ndarray:
    """``img`` with seeded Gaussian noise, uint8."""
    rng = np.random.RandomState(seed)
    return np.clip(img + rng.randn(*img.shape) * sigma, 0, 255).round().astype(np.uint8)


def _normal(rng, shape, fan_in=None) -> torch.Tensor:
    fan_in = fan_in or int(np.prod(shape[1:]))
    return torch.from_numpy((rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32))


def _bn(sd: dict, name: str, c: int, rng) -> None:
    sd[f"{name}.weight"] = torch.from_numpy(rng.uniform(0.8, 1.2, c).astype(np.float32))
    sd[f"{name}.bias"] = torch.from_numpy((rng.randn(c) * 0.01).astype(np.float32))
    sd[f"{name}.running_mean"] = torch.from_numpy((rng.randn(c) * 0.01).astype(np.float32))
    sd[f"{name}.running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))


def _bias(rng, c: int) -> torch.Tensor:
    return torch.from_numpy((rng.randn(c) * 0.05).astype(np.float32))


def write_lpips(root: str, seed: int = 0) -> tuple[str, str]:
    """(alex.pth with the heads, alexnet.pth with the backbone convs)."""
    rng = np.random.RandomState(seed)
    backbone = {}
    for idx, co, ci, k in ALEX_CONVS:
        backbone[f"features.{idx}.weight"] = _normal(rng, (co, ci, k, k))
        backbone[f"features.{idx}.bias"] = _bias(rng, co)
    heads = {f"lin{i}.model.1.weight": torch.from_numpy(
        np.abs(rng.randn(1, co, 1, 1)).astype(np.float32) * 0.1)
        for i, (_, co, _, _) in enumerate(ALEX_CONVS)}
    paths = os.path.join(root, "alex.pth"), os.path.join(root, "alexnet.pth")
    torch.save(heads, paths[0])
    torch.save(backbone, paths[1])
    return paths


def write_dists(root: str, seed: int = 0) -> tuple[str, str]:
    """(weights.pt with alpha / beta, vgg16.pth with the convs)."""
    rng = np.random.RandomState(seed)
    backbone, cin, idx = {}, 3, 0
    for feats, n_convs in VGG16_STAGES:
        for _ in range(n_convs):
            backbone[f"features.{idx}.weight"] = _normal(rng, (feats, cin, 3, 3))
            backbone[f"features.{idx}.bias"] = _bias(rng, feats)
            cin, idx = feats, idx + 2
        idx += 1                                        # the max pool
    backbone["classifier.0.weight"] = _normal(rng, (8, 16))
    total_c = 3 + sum(c for c, _ in VGG16_STAGES)
    ab = {name: torch.from_numpy(np.abs(rng.randn(1, total_c, 1, 1)).astype(np.float32))
          for name in ("alpha", "beta")}
    paths = os.path.join(root, "dists_weights.pt"), os.path.join(root, "vgg16.pth")
    torch.save(ab, paths[0])
    torch.save(backbone, paths[1])
    return paths


# torchvision inception_v3's BasicConv2d modules with their (cout, cin, kh, kw)
def _fid_convs():
    out = [("Conv2d_1a_3x3", 32, 3, 3, 3), ("Conv2d_2a_3x3", 32, 32, 3, 3),
           ("Conv2d_2b_3x3", 64, 32, 3, 3), ("Conv2d_3b_1x1", 80, 64, 1, 1),
           ("Conv2d_4a_3x3", 192, 80, 3, 3)]

    def a(name, cin, pool):
        return [(f"{name}.branch1x1", 64, cin, 1, 1), (f"{name}.branch5x5_1", 48, cin, 1, 1),
                (f"{name}.branch5x5_2", 64, 48, 5, 5), (f"{name}.branch3x3dbl_1", 64, cin, 1, 1),
                (f"{name}.branch3x3dbl_2", 96, 64, 3, 3),
                (f"{name}.branch3x3dbl_3", 96, 96, 3, 3), (f"{name}.branch_pool", pool, cin, 1, 1)]

    def c(name, c7):
        return [(f"{name}.branch1x1", 192, 768, 1, 1), (f"{name}.branch7x7_1", c7, 768, 1, 1),
                (f"{name}.branch7x7_2", c7, c7, 1, 7), (f"{name}.branch7x7_3", 192, c7, 7, 1),
                (f"{name}.branch7x7dbl_1", c7, 768, 1, 1),
                (f"{name}.branch7x7dbl_2", c7, c7, 7, 1),
                (f"{name}.branch7x7dbl_3", c7, c7, 1, 7),
                (f"{name}.branch7x7dbl_4", c7, c7, 7, 1),
                (f"{name}.branch7x7dbl_5", 192, c7, 1, 7), (f"{name}.branch_pool", 192, 768, 1, 1)]

    def e(name, cin):
        return [(f"{name}.branch1x1", 320, cin, 1, 1), (f"{name}.branch3x3_1", 384, cin, 1, 1),
                (f"{name}.branch3x3_2a", 384, 384, 1, 3), (f"{name}.branch3x3_2b", 384, 384, 3, 1),
                (f"{name}.branch3x3dbl_1", 448, cin, 1, 1),
                (f"{name}.branch3x3dbl_2", 384, 448, 3, 3),
                (f"{name}.branch3x3dbl_3a", 384, 384, 1, 3),
                (f"{name}.branch3x3dbl_3b", 384, 384, 3, 1), (f"{name}.branch_pool", 192, cin, 1, 1)]

    out += a("Mixed_5b", 192, 32) + a("Mixed_5c", 256, 64) + a("Mixed_5d", 288, 64)
    out += [("Mixed_6a.branch3x3", 384, 288, 3, 3), ("Mixed_6a.branch3x3dbl_1", 64, 288, 1, 1),
            ("Mixed_6a.branch3x3dbl_2", 96, 64, 3, 3), ("Mixed_6a.branch3x3dbl_3", 96, 96, 3, 3)]
    out += c("Mixed_6b", 128) + c("Mixed_6c", 160) + c("Mixed_6d", 160) + c("Mixed_6e", 192)
    out += [("Mixed_7a.branch3x3_1", 192, 768, 1, 1), ("Mixed_7a.branch3x3_2", 320, 192, 3, 3),
            ("Mixed_7a.branch7x7x3_1", 192, 768, 1, 1), ("Mixed_7a.branch7x7x3_2", 192, 192, 1, 7),
            ("Mixed_7a.branch7x7x3_3", 192, 192, 7, 1), ("Mixed_7a.branch7x7x3_4", 192, 192, 3, 3)]
    return out + e("Mixed_7b", 1280) + e("Mixed_7c", 2048)


def write_fid_inception(path: str, seed: int = 0) -> str:
    rng = np.random.RandomState(seed)
    sd = {}
    for name, co, ci, kh, kw in _fid_convs():
        sd[f"{name}.conv.weight"] = _normal(rng, (co, ci, kh, kw))
        _bn(sd, f"{name}.bn", co, rng)
    sd["fc.weight"] = _normal(rng, (1008, 2048))
    sd["fc.bias"] = _bias(rng, 1008)
    torch.save(sd, path)
    return path


def clip_rn50_state_dict(seed: int = 0, width: int = 8, layers=(1, 1, 1, 1), embed: int = 16,
                         twidth: int = 64, tlayers: int = 2, vocab: int = 512,
                         spacial: int = 7) -> dict:
    """OpenAI CLIP's ModifiedResNet + text transformer keys; the defaults are
    the tiny RN50 of tests/test_metrics.py (one block a layer, 2 text blocks)."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, co, ci, k):
        sd[f"{name}.weight"] = _normal(rng, (co, ci, k, k))

    def dense(name, co, ci):
        sd[f"{name}.weight"] = _normal(rng, (co, ci))
        sd[f"{name}.bias"] = _bias(rng, co)

    def ln(name, c):
        sd[f"{name}.weight"] = torch.from_numpy(rng.uniform(0.8, 1.2, c).astype(np.float32))
        sd[f"{name}.bias"] = _bias(rng, c)

    conv("visual.conv1", width // 2, 3, 3)
    _bn(sd, "visual.bn1", width // 2, rng)
    conv("visual.conv2", width // 2, width // 2, 3)
    _bn(sd, "visual.bn2", width // 2, rng)
    conv("visual.conv3", width, width // 2, 3)
    _bn(sd, "visual.bn3", width, rng)
    cin = width
    for li, blocks in enumerate(layers, start=1):
        planes = width * 2 ** (li - 1)
        for j in range(blocks):
            base = f"visual.layer{li}.{j}"
            conv(f"{base}.conv1", planes, cin, 1)
            _bn(sd, f"{base}.bn1", planes, rng)
            conv(f"{base}.conv2", planes, planes, 3)
            _bn(sd, f"{base}.bn2", planes, rng)
            conv(f"{base}.conv3", planes * 4, planes, 1)
            _bn(sd, f"{base}.bn3", planes * 4, rng)
            if j == 0:
                conv(f"{base}.downsample.0", planes * 4, cin, 1)
                _bn(sd, f"{base}.downsample.1", planes * 4, rng)
            cin = planes * 4
    ap = "visual.attnpool"
    sd[f"{ap}.positional_embedding"] = torch.from_numpy(
        rng.randn(spacial ** 2 + 1, cin).astype(np.float32) * 0.02)
    for n in ("q_proj", "k_proj", "v_proj"):
        dense(f"{ap}.{n}", cin, cin)
    dense(f"{ap}.c_proj", embed, cin)
    sd["token_embedding.weight"] = torch.from_numpy(
        rng.randn(vocab, twidth).astype(np.float32) * 0.02)
    sd["positional_embedding"] = torch.from_numpy(rng.randn(77, twidth).astype(np.float32) * 0.01)
    for i in range(tlayers):
        b = f"transformer.resblocks.{i}"
        ln(f"{b}.ln_1", twidth)
        sd[f"{b}.attn.in_proj_weight"] = _normal(rng, (3 * twidth, twidth))
        sd[f"{b}.attn.in_proj_bias"] = _bias(rng, 3 * twidth)
        dense(f"{b}.attn.out_proj", twidth, twidth)
        ln(f"{b}.ln_2", twidth)
        dense(f"{b}.mlp.c_fc", 4 * twidth, twidth)
        dense(f"{b}.mlp.c_proj", twidth, 4 * twidth)
    ln("ln_final", twidth)
    sd["text_projection"] = _normal(rng, (twidth, embed))
    sd["logit_scale"] = torch.tensor(np.log(1 / 0.07), dtype=torch.float32)
    return sd


def write_clip_rn50(path: str, **kw) -> str:
    torch.save({"state_dict": clip_rn50_state_dict(**kw)}, path)
    return path


def prompt_tokens(vocab: int, pairs: int = 5, seed: int = 0) -> np.ndarray:
    """(2 * pairs, 77) token ids: start token, 1-4 words, end token (the
    largest id), zeros after, all below ``vocab``."""
    rng = np.random.RandomState(seed)
    toks = np.zeros((2 * pairs, 77), np.int64)
    for i in range(2 * pairs):
        n = 1 + i % 4
        toks[i, 0] = vocab - 2
        toks[i, 1:1 + n] = rng.randint(1, vocab - 2, n)
        toks[i, 1 + n] = vocab - 1
    return toks


def write_merges(path: str) -> str:
    """A BPE merges file over the letters of the antonym prompts: a header
    line, then pairs building a few words."""
    merges = ["i m", "im a", "ima g", "imag e</w>", "b a", "ba d</w>", "s h", "sh a", "sha r",
              "shar p</w>", "e d", "ed g", "edg e", "edge s</w>", "n o", "no i", "noi s",
              "nois y</w>", "h i", "hi g", "hig h</w>", "r e", "l o", "lo w</w>", "g o",
              "go o", "goo d</w>", "b l", "bl u"]
    with open(path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return path


def assert_same_lines(got: str, want: str, atol: float) -> None:
    """Two scripts' printed lines: equal with every decimal number taken
    out, and the numbers within ``atol`` of each other."""
    import re
    num = re.compile(r"-?\d+\.\d+")
    got, want = got.splitlines(), want.splitlines()
    assert len(got) == len(want) and got, (got, want)
    for g, w in zip(got, want):
        assert num.sub("#", g) == num.sub("#", w), (g, w)
        np.testing.assert_allclose([float(v) for v in num.findall(g)],
                                   [float(v) for v in num.findall(w)], rtol=0, atol=atol,
                                   err_msg=f"{g!r} against {w!r}")
