"""The port's CLIP-IQA, CLIP RN50 towers and BPE tokenizer against ssl_tpu's
on the same OpenAI-layout checkpoint: the tiny RN50 of tests/test_metrics.py
(width 8, embed 16, text width 64, 2 blocks), written with random batch
norm statistics by ``tests/torch_metric_cases.py``.

Tolerances: the score within 1e-6 absolute (float32 towers, the softmax of
cosine logits in numpy float32 in both); the towers' features rtol 1e-5
(float32, products in other orders); the tokenizer's ids exactly, on a
merges file the test writes; the weight carry exactly.  MUSIQ raises in
both packages where ``pyiqa`` does not import."""

import os
import runpy
import sys

import numpy as np
import pytest
import torch

from ssl_tpu.archs import clip_arch as jclip
from ssl_tpu.metrics import clipiqa as jiqa
from ssl_tpu.utils.clip_tokenizer import SimpleTokenizer as JTokenizer
from ssl_tpu.utils.weight_port import convert_clip_rn50
from ssl_tpu_torch.metrics import calculate_metric
from ssl_tpu_torch.metrics import clipiqa as tiqa
from ssl_tpu_torch.scripts.metrics import calculate_clipiqa as tcli
from ssl_tpu_torch.scripts.metrics import calculate_musiq as tmusiq
from ssl_tpu_torch.utils.clip_tokenizer import SimpleTokenizer as TTokenizer
from ssl_tpu_torch.utils.weight_port import params_from_jax
from torch_metric_cases import (assert_same_lines, clip_rn50_state_dict, picture, prompt_tokens,
                                write_clip_rn50, write_merges)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the suite runs several test processes on the
    machine's cores, beside JAX's own thread pool in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def merges(tmp_path_factory):
    return write_merges(str(tmp_path_factory.mktemp("bpe") / "merges.txt"))


@pytest.fixture(scope="module")
def vocab(merges):
    """The merges file's vocabulary: 512 bytes, its merges, start and end."""
    return len(TTokenizer(merges).encoder)


@pytest.fixture(scope="module")
def clip_path(tmp_path_factory, vocab):
    return write_clip_rn50(str(tmp_path_factory.mktemp("clip") / "rn50.pt"), seed=3, vocab=vocab)


def test_clipiqa_matches_jax(clip_path, vocab):
    """Through the dispatcher, prompt tokens as an argument (the entry
    point's test takes them from the merges file)."""
    toks = prompt_tokens(vocab)
    img = picture(64, 64, 1)
    want = jiqa.calculate_clipiqa(img, weights_path=clip_path, prompt_tokens=toks)
    got = calculate_metric({"img": img, "device": "cpu"},
                           {"type": "calculate_clipiqa", "weights_path": clip_path,
                            "prompt_tokens": toks})
    assert 0.0 < got < 1.0 and abs(got - 0.5) > 1e-4
    assert abs(got - want) < 1e-6


def test_towers_and_carry_match_jax(clip_path, vocab):
    """The JAX towers on ssl_tpu's converted tree; the port's towers on that
    tree carried back by params_from_jax (equal to the file), the attention
    pool without its positional embedding (CLIP-IQA's mode)."""
    sd = torch.load(clip_path)["state_dict"]
    vis_p, vis_s, text_p = convert_clip_rn50(sd)
    carried = params_from_jax("CLIPRN50", {"visual": vis_p, "text": text_p}, vis_s)
    assert set(carried) == set(sd) - {"logit_scale"}
    for k, v in carried.items():
        assert torch.equal(v, sd[k]), k
    visual, text, scale = tiqa.clip_towers(carried)
    assert scale == 100.0                                  # no logit_scale in the carry
    jvis = jclip.ModifiedResNet(layers=(1, 1, 1, 1), width=8, output_dim=16, heads=4)
    jtext = jclip.CLIPTextEncoder(vocab_size=vocab, width=64, layers=2, heads=1, embed_dim=16)
    x = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    want = np.asarray(jvis.apply({"params": vis_p, "batch_stats": vis_s}, x, use_pos=False))
    with torch.no_grad():
        got = visual.eval()(xt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    toks = prompt_tokens(vocab)
    want = np.asarray(jtext.apply({"params": text_p}, toks))
    with torch.no_grad():
        got = text(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_tokenizer_matches_jax(merges, monkeypatch):
    texts = tiqa.ANTONYM_PROMPTS + ["A  Noise-free, HIGH-resolution image &amp; 2 edges!"]
    want = JTokenizer(merges).tokenize(texts)
    got = TTokenizer(merges).tokenize(texts)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (11, 77) and got.max() == len(TTokenizer(merges).encoder) - 1
    assert TTokenizer(merges).encode("good image") == JTokenizer(merges).encode("good image")
    monkeypatch.setenv("CLIP_BPE_PATH", merges)
    monkeypatch.delenv("CLIP_PROMPT_TOKENS_NPY", raising=False)
    np.testing.assert_array_equal(tiqa.prompt_token_ids(), want[:10])
    monkeypatch.delenv("CLIP_BPE_PATH")
    with pytest.raises(FileNotFoundError, match="prompt token"):
        tiqa.prompt_token_ids()


def test_clipiqa_entry_point(clip_path, merges, tmp_path, monkeypatch, capsys):
    """The JAX script and the port's on one folder: the same lines, the
    scores within 1e-6; the tokens from CLIP_BPE_PATH in both (the tower's
    vocab is the merges file's)."""
    import cv2
    folder = tmp_path / "sr"
    os.makedirs(folder)
    for i in range(2):
        cv2.imwrite(str(folder / f"im{i}.png"), picture(64, 64, 30 + i)[..., ::-1])
    (folder / "notes.txt").write_text("not an image")
    monkeypatch.setenv("CLIP_BPE_PATH", merges)
    monkeypatch.delenv("CLIP_PROMPT_TOKENS_NPY", raising=False)
    monkeypatch.setattr(sys, "argv", ["calculate_clipiqa.py", "--restored", str(folder),
                                      "--weights", clip_path])
    runpy.run_path(os.path.join(REPO, "scripts", "metrics", "calculate_clipiqa.py"),
                   run_name="__main__")
    want = capsys.readouterr().out
    tcli.main(["--restored", str(folder), "--weights", clip_path, "--device", "cpu"])
    got = capsys.readouterr().out
    assert len(got.splitlines()) == 3 and "Average CLIPIQA: " in got
    assert_same_lines(got, want, atol=2e-6)              # 1e-6 and the 6th decimal's rounding


def test_musiq_needs_pyiqa(tmp_path, monkeypatch, capsys):
    import cv2
    cv2.imwrite(str(tmp_path / "im.png"), picture(32, 32, 0)[..., ::-1])
    monkeypatch.setitem(sys.modules, "pyiqa", None)
    with pytest.raises(ImportError, match="pyiqa"):
        jiqa.calculate_musiq(picture(32, 32, 0))
    with pytest.raises(ImportError, match="pyiqa"):
        tmusiq.main(["--restored", str(tmp_path)])
    assert capsys.readouterr().out == ""


def test_missing_weights_raise(monkeypatch):
    monkeypatch.delenv("CLIP_RN50_PTH", raising=False)
    with pytest.raises(FileNotFoundError, match="CLIP_RN50_PTH"):
        tiqa.calculate_clipiqa(picture(32, 32, 0), device="cpu")
    sd = clip_rn50_state_dict()
    del sd["visual.layer2.0.conv2.weight"]
    with pytest.raises(ValueError, match="incomplete"):
        tiqa.clip_towers(sd)
