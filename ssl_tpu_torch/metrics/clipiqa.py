"""CLIP-IQA — no-reference quality from CLIP antonym prompts.

Counterpart of ``ssl_tpu/metrics/clipiqa.py`` (reference:
scripts/metrics/calculate_clipiqa.py and the vendored
clipiqa_pyiqa/clipiqa_arch.py, ``model_type='clipiqa'``, :96-132): the image
is encoded without the attention pool's positional embedding (any input
size works), the five antonym prompt pairs of ``ANTONYM_PROMPTS`` through
the text tower, logits scaled by the model's learned ``exp(logit_scale)``,
a softmax per pair, and the score the mean of the positive side.

The CLIP RN50 weights (OpenAI's layout) come from CLIP_RN50_PTH; the prompt
token ids from an argument, CLIP_PROMPT_TOKENS_NPY or the BPE merges at
CLIP_BPE_PATH.  Without them the metric raises.  MUSIQ needs the ``pyiqa``
package, as in the reference."""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from ssl_tpu_torch.archs.clip_arch import CLIPTextEncoder, ModifiedResNet
from ssl_tpu_torch.metrics.metric_util import exact_float32, image_tensor
from ssl_tpu_torch.utils.device import resolve_device
from ssl_tpu_torch.utils.registry import METRIC_REGISTRY
from ssl_tpu_torch.utils.weight_port import load_torch_state_dict

ANTONYM_PROMPTS = [
    "Good image", "bad image",
    "Sharp image", "blurry image",
    "sharp edges", "blurry edges",
    "High resolution image", "low resolution image",
    "Noise-free image", "noisy image",
]


def clipiqa_score(image_features: np.ndarray, text_features: np.ndarray,
                  logit_scale: float = 100.0) -> float:
    """Cosine logits of one image against 2k antonym text features (rows
    ordered positive, negative per pair), a softmax per pair, the mean
    positive probability (clipiqa_arch.py:124-132)."""
    img = image_features / (np.linalg.norm(image_features) + 1e-10)
    txt = text_features / (np.linalg.norm(text_features, axis=-1, keepdims=True) + 1e-10)
    logits = (logit_scale * txt @ img).reshape(-1, 2)
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    probs = e / e.sum(axis=-1, keepdims=True)
    return float(probs[:, 0].mean())


_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

_CACHE: dict = {}


def clip_towers(sd: dict) -> tuple[ModifiedResNet, CLIPTextEncoder, float]:
    """The visual and text towers of an OpenAI-layout RN50 state dict, their
    widths read from the tensors, with the weights loaded; and
    ``exp(logit_scale)`` (100 where the file has none)."""
    width = sd["visual.conv1.weight"].shape[0] * 2
    embed = sd["text_projection"].shape[1]
    twidth = sd["positional_embedding"].shape[1]
    counts = [0, 0, 0, 0]
    for k in sd:
        m = re.match(r"visual\.layer(\d)\.(\d+)\.conv1\.weight", k)
        if m:
            li, j = int(m.group(1)), int(m.group(2))
            counts[li - 1] = max(counts[li - 1], j + 1)
    spacial = int(round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5))
    visual = ModifiedResNet(layers=tuple(counts), output_dim=embed, heads=width // 2,
                            width=width, attn_spacial_dim=spacial)
    text = CLIPTextEncoder(vocab_size=sd["token_embedding.weight"].shape[0],
                           context_length=sd["positional_embedding"].shape[0], width=twidth,
                           layers=len([k for k in sd if k.endswith(".ln_1.weight")]),
                           heads=max(1, twidth // 64), embed_dim=embed)
    visual.load_state_dict({k[len("visual."):]: v for k, v in sd.items()
                            if k.startswith("visual.")}, strict=False)
    text_sd = {k: v for k, v in sd.items() if k in text.state_dict()}
    text.load_state_dict(text_sd)
    missing = [k for k in visual.state_dict()
               if f"visual.{k}" not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"CLIP RN50 weights incomplete: visual {missing[:3]} missing")
    logit_scale = float(np.exp(np.asarray(sd["logit_scale"], np.float32))) \
        if "logit_scale" in sd else 100.0
    return visual, text, logit_scale


def _load_clip(path: str, device):
    key = (path, str(device))
    if key not in _CACHE:
        visual, text, logit_scale = clip_towers(load_torch_state_dict(path, "state_dict"))
        _CACHE[key] = (visual.to(device).eval().requires_grad_(False),
                       text.to(device).eval().requires_grad_(False), logit_scale)
    return _CACHE[key]


def prompt_token_ids(prompt_tokens=None) -> np.ndarray:
    """(2k, 77) token ids: ``prompt_tokens``, else CLIP_PROMPT_TOKENS_NPY,
    else ``ANTONYM_PROMPTS`` tokenized with the merges at CLIP_BPE_PATH."""
    if prompt_tokens is not None:
        return np.asarray(prompt_tokens)
    tok_path = os.environ.get("CLIP_PROMPT_TOKENS_NPY")
    if tok_path and os.path.exists(tok_path):
        return np.load(tok_path)
    if os.environ.get("CLIP_BPE_PATH"):
        from ssl_tpu_torch.utils.clip_tokenizer import SimpleTokenizer
        return SimpleTokenizer().tokenize(ANTONYM_PROMPTS)
    raise FileNotFoundError(
        "CLIPIQA needs the antonym prompt token ids: pass prompt_tokens, "
        "set CLIP_PROMPT_TOKENS_NPY to a (2k,77) int .npy, or set "
        "CLIP_BPE_PATH to the CLIP merges file for on-the-fly tokenizing.")


@METRIC_REGISTRY.register()
def calculate_clipiqa(img, weights_path=None, prompt_tokens=None, device=None,
                      **kwargs) -> float:
    """img: HWC uint8/float [0,255] RGB; weights_path: an OpenAI CLIP RN50
    checkpoint (else CLIP_RN50_PTH).  Higher is better."""
    path = weights_path or os.environ.get("CLIP_RN50_PTH")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "CLIPIQA requires CLIP RN50 weights (set CLIP_RN50_PTH to an OpenAI "
            "CLIP RN50 checkpoint).")
    tokens = prompt_token_ids(prompt_tokens)
    device = resolve_device(device)
    visual, text, logit_scale = _load_clip(path, device)
    mean, std = (torch.from_numpy(v).to(device).view(1, 3, 1, 1) for v in (_CLIP_MEAN, _CLIP_STD))
    x = (image_tensor(img, 0, device) - mean) / std
    with torch.no_grad(), exact_float32():
        feats = visual(x)
        tfeats = text(torch.as_tensor(tokens, dtype=torch.long, device=device))
    return clipiqa_score(feats[0].cpu().numpy(), tfeats.cpu().numpy(), logit_scale)


@METRIC_REGISTRY.register()
def calculate_musiq(img, **kwargs) -> float:
    """MUSIQ (the reference's calculate_musiq.py uses the pyiqa package);
    raises where pyiqa does not import."""
    try:
        import pyiqa
    except ImportError as e:
        raise ImportError("MUSIQ requires the 'pyiqa' package (the reference's dependency), "
                          "which is not installed.") from e
    model = pyiqa.create_metric("musiq")
    t = torch.from_numpy(np.asarray(img, np.float32) / 255.0).permute(2, 0, 1)[None]
    return float(model(t))
