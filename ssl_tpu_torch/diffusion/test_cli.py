"""Diffusion-tree inference CLI (reference surface: Diffusion-Based-SR/test.py).

Counterpart of ``ssl_tpu/diffusion/test_cli.py``, with the same arguments:

    python -m ssl_tpu_torch.diffusion.test_cli --config cfg.yml --ckpt ckpt_N.pkl \\
        --init-img lq/ --outdir out [--ddpm_steps 200] [--sampler ddpm|ddim|plms] \\
        [--colorfix_type adain|wavelet|nofix] [--tile_latent 8] [--device cpu]

For each LQ image: bicubic upsampling by ``--upscale`` (to a multiple of 64),
VAE encode, the sampler over the struct-cond encoder and the dual-cond UNet,
VAE decode, color fix, PNG out (``restore`` is one such request, without
the file handling).  ``--ckpt`` is the JAX package's params
pickle (``{'unet', 'structcond', 'null_context'}`` with numpy leaves, as
``ssl_tpu.diffusion.main`` saves it), carried over with ``params_from_jax``;
sampling uses those weights.  A config with ``model.compute_dtype:
bfloat16`` serves in bf16 (the nets' activations and K2's bf16 kernels on
float32 weights; the sampler's latents stay float32).  Runs on ``cuda``
unless ``--device`` names another device.  Images are read and written
through ``utils/img_util.py`` (``cv2`` where it imports, else
``utils/png.py``), and a ``.json`` config needs no ``yaml``.
``--vqgan_ckpt`` (CFW), ``--tp``, ``--tile_parallel`` and ``--prompt`` are not
ported yet and raise."""

from __future__ import annotations

import argparse
import os
import pickle
import time

import torch
import torch.nn.functional as F

from ssl_tpu_torch.diffusion.color_fix import adain_color_fix, wavelet_color_fix
from ssl_tpu_torch.diffusion.ddpm_ssl import DiffusionState
from ssl_tpu_torch.diffusion.main import build_from_config
from ssl_tpu_torch.diffusion.sampler import (ddim_sample, plms_sample, spaced_ddpm_sample,
                                             tiled_sample)
from ssl_tpu_torch.utils.img_util import img2array, img2tensor, imread, imwrite, tensor2img
from ssl_tpu_torch.utils.options import ordered_yaml_load
from ssl_tpu_torch.utils.weight_port import params_from_jax

SAMPLERS = {"ddpm": spaced_ddpm_sample, "ddim": ddim_sample, "plms": plms_sample}


def load_jax_params(state: DiffusionState, params: dict) -> None:
    """Carry a JAX params tree into the state's weights and their EMA, so
    that sampling (which reads the EMA) uses the loaded weights.  Values are
    copied in place: the optimizer keeps the same tensors."""
    carried = params_from_jax("StableSRSSL", params)
    for p in (state.params, state.ema_params):
        if p is None:
            continue
        p["unet"].load_state_dict(carried["unet"])
        p["structcond"].load_state_dict(carried["structcond"])
        with torch.no_grad():
            p["null_context"].copy_(carried["null_context"])


def restore(model, state: DiffusionState, lq_up: torch.Tensor, generator: torch.Generator,
            sampler: str = "ddpm", steps: int = 200, tile_latent: int = 0,
            colorfix: str = "adain", timings: dict | None = None) -> torch.Tensor:
    """One request: the upsampled LQ image (1, 3, H, W) in [0, 1] -> the
    restored image in [0, 1].  VAE encode, ``sampler`` over the struct-cond
    encoder and the UNet with the sampling-time weights (tiled when
    ``tile_latent`` is set and smaller than the latent), VAE decode, color
    fix.  With ``timings``, each stage's seconds go into it, the device
    synchronised after each."""
    vae, params = state.frozen["vae"], model.infer_params(state)
    sample = SAMPLERS[sampler]
    ctx = params["null_context"][None]
    clock = [time.perf_counter()]

    def lap(stage):
        if timings is not None:
            if lq_up.is_cuda:
                torch.cuda.synchronize(lq_up.device)
            now = time.perf_counter()
            timings[stage] = now - clock[0]
            clock[0] = now

    def apply_fn(x, t, c, z_lq):
        return model.apply_model(params, x, t, c, z_lq)

    def sample_tile(z_tile):
        return sample(apply_fn, model.sched, z_tile.shape, generator, ctx, z_tile, steps=steps)

    with torch.no_grad():
        z_lq = model.encode(vae, lq_up * 2 - 1, generator)
        lap("encode")
        if tile_latent and max(z_lq.shape[-2:]) > tile_latent:
            z = tiled_sample(sample_tile, z_lq, tile_latent, tile_latent // 4)
        else:
            z = sample_tile(z_lq)
        lap("sample")
        img = torch.clamp((model.decode(vae, z) + 1) / 2, 0, 1)
        lap("decode")
    if colorfix == "adain":
        img = adain_color_fix(img, lq_up)
    elif colorfix == "wavelet":
        img = wavelet_color_fix(img, lq_up)
    lap("colorfix")
    return img


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--init-img", dest="init_img", required=True, help="LQ folder")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--ddpm_steps", type=int, default=200)
    parser.add_argument("--upscale", type=float, default=4.0)
    parser.add_argument("--colorfix_type", choices=["nofix", "adain", "wavelet"], default="adain")
    parser.add_argument("--vqgan_ckpt", default=None, help="CFW decoder (not ported yet)")
    parser.add_argument("--tile_latent", type=int, default=0, help="latent tile size (0=off)")
    parser.add_argument("--tile_parallel", action="store_true", help="not ported yet")
    parser.add_argument("--tp", type=int, default=0, help="not ported yet")
    parser.add_argument("--prompt", default=None, help="not ported yet (needs CLIP weights)")
    parser.add_argument("--sampler", choices=sorted(SAMPLERS), default="ddpm")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    for given, flag in ((args.vqgan_ckpt, "--vqgan_ckpt"), (args.tp and args.tp > 1, "--tp"),
                        (args.tile_parallel, "--tile_parallel"),
                        (args.prompt is not None, "--prompt")):
        if given:
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP.md, queue 1)")
    model = build_from_config(ordered_yaml_load(args.config))
    state = model.init_state(seed=0, device=args.device)
    with open(args.ckpt, "rb") as f:
        load_jax_params(state, pickle.load(f))
    device = state.params["null_context"].device
    gen = torch.Generator(device=device).manual_seed(42)
    os.makedirs(args.outdir, exist_ok=True)
    for name in sorted(os.listdir(args.init_img)):
        path = os.path.join(args.init_img, name)
        lq = img2tensor(img2array(imread(path)))[None]
        h, w = lq.shape[-2:]
        up_h, up_w = int(h * args.upscale) // 64 * 64, int(w * args.upscale) // 64 * 64
        # cv2.resize's INTER_CUBIC (A = -0.75, pixel centres, clamped border),
        # which the JAX CLI calls, is this interpolation
        lq_up = F.interpolate(lq, size=(up_h, up_w), mode="bicubic", align_corners=False)
        img = restore(model, state, lq_up.to(device), gen, args.sampler, args.ddpm_steps,
                      args.tile_latent, args.colorfix_type)
        out_path = os.path.join(args.outdir, name)
        imwrite(tensor2img(img), out_path)
        print(f"{path} -> {out_path}")


if __name__ == "__main__":
    main()
