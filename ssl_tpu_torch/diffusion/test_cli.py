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

Under ``torchrun`` (one rank per card; gloo with ``--device cpu``) ``--tp N``
splits the UNet's and the struct-cond encoder's Megatron layers over the N
ranks (``parallel/tensor.py``; the world must be N), and ``--tile_parallel``
hands each rank its tile of each group of latent tiles
(``sampler.py::tiled_sample``); every rank samples and rank 0 writes:

    torchrun --nproc_per_node 2 -m ssl_tpu_torch.diffusion.test_cli --config cfg.yml \\
        --ckpt ckpt_N.pkl --init-img lq/ --outdir out --tp 2

``--vqgan_ckpt cfw_N.pkl`` decodes through StableSR's CFW autoencoder
(``diffusion/vae.py::AutoencoderKLResi``, built from ``model.first_stage``
with the model's flash switch and ``compute_dtype``; the ``{'params': tree}``
pickle either package's ``cfw_train`` writes): the upscaled LQ's encoder
features fused into the decode of latent / ``scale_factor``, once the whole
latent canvas is sampled (and gathered, with ``--tile_latent``, ``--tp`` or
``--tile_parallel``).  ``--prompt`` is not ported yet and raises."""

from __future__ import annotations

import argparse
import inspect
import os
import pickle
import time

import torch
import torch.nn.functional as F

from ssl_tpu_torch.diffusion.cfw_train import read_cfw_params
from ssl_tpu_torch.diffusion.color_fix import adain_color_fix, wavelet_color_fix
from ssl_tpu_torch.diffusion.ddpm_ssl import DiffusionState
from ssl_tpu_torch.diffusion.main import build_from_config, load_config
from ssl_tpu_torch.diffusion.sampler import (ddim_sample, plms_sample, spaced_ddpm_sample,
                                             tiled_sample)
from ssl_tpu_torch.diffusion.vae import AutoencoderKLResi
from ssl_tpu_torch.parallel.mesh import dp_tp_mesh, init_distributed, is_main
from ssl_tpu_torch.utils.img_util import img2array, img2tensor, imread, imwrite, tensor2img
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


def load_cfw(cfg: dict, path: str, device) -> AutoencoderKLResi:
    """The CFW autoencoder of ``--vqgan_ckpt``: built from ``cfg``'s
    ``model.first_stage`` (its AutoencoderKLResi keys) with the model's
    ``use_flash_attention`` and ``compute_dtype``, the pickle loaded.  A
    ``num_fuse_block`` that ``first_stage`` does not give is read from the
    pickle (the JAX CLI takes the default, 2; a stage-1 config cannot carry
    the key, which AutoencoderKL does not take)."""
    tree = read_cfw_params(path)
    model_cfg = cfg.get("model", {})
    keys = inspect.signature(AutoencoderKLResi).parameters
    vae_cfg = {k: v for k, v in (model_cfg.get("first_stage") or {}).items() if k in keys}
    for key in ("use_flash_attention", "compute_dtype"):
        if model_cfg.get(key):
            vae_cfg.setdefault(key, model_cfg[key])
    fuse = tree["decoder"].get("fusion_layer_1", {})
    vae_cfg.setdefault("num_fuse_block",
                       sum(k.startswith("encode_enc_2_") for k in fuse) or 2)
    with torch.device("meta"):
        net = AutoencoderKLResi(**vae_cfg)
    net = net.to_empty(device=device)
    net.load_state_dict(params_from_jax("AutoencoderKLResi", tree))
    return net.requires_grad_(False).eval()


def restore(model, state: DiffusionState, lq_up: torch.Tensor, generator: torch.Generator,
            sampler: str = "ddpm", steps: int = 200, tile_latent: int = 0,
            colorfix: str = "adain", timings: dict | None = None,
            tile_parallel: bool = False, cfw: AutoencoderKLResi | None = None) -> torch.Tensor:
    """One request: the upsampled LQ image (1, 3, H, W) in [0, 1] -> the
    restored image in [0, 1].  VAE encode, ``sampler`` over the struct-cond
    encoder and the UNet with the sampling-time weights (tiled when
    ``tile_latent`` is set and smaller than the latent), the decode (the VAE,
    or with ``cfw`` the CFW autoencoder on the LQ's encoder features), color
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
            z = tiled_sample(sample_tile, z_lq, tile_latent, tile_latent // 4,
                             data_parallel=tile_parallel)
        else:
            z = sample_tile(z_lq)
        lap("sample")
        if cfw is None:
            img = model.decode(vae, z)
        else:
            img = cfw.decode(z / model.cfg.scale_factor, cfw.encode(lq_up * 2 - 1)[2])
        img = torch.clamp((img + 1) / 2, 0, 1)
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
    parser.add_argument("--vqgan_ckpt", default=None,
                        help="CFW autoencoder params pickle (cfw_train's cfw_N.pkl)")
    parser.add_argument("--tile_latent", type=int, default=0, help="latent tile size (0=off)")
    parser.add_argument("--tile_parallel", action="store_true",
                        help="latent tiles split over the ranks (torchrun)")
    parser.add_argument("--tp", type=int, default=0,
                        help="the UNet split over this many ranks (torchrun)")
    parser.add_argument("--prompt", default=None, help="not ported yet (needs CLIP weights)")
    parser.add_argument("--sampler", choices=sorted(SAMPLERS), default="ddpm")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.prompt is not None:
        raise NotImplementedError("--prompt is not ported yet (ROADMAP.md, queue 1)")
    if args.vqgan_ckpt and not os.path.isfile(args.vqgan_ckpt):
        raise FileNotFoundError(args.vqgan_ckpt)
    tp = max(args.tp or 1, 1)
    if tp > 1 and args.tile_parallel:
        raise ValueError("--tp and --tile_parallel split the ranks two ways: take one")
    device, mesh = args.device, None
    if "WORLD_SIZE" in os.environ and (tp > 1 or args.tile_parallel):
        device = init_distributed("cuda" if device is None else device)
    if tp > 1:
        mesh = dp_tp_mesh({"data": 1, "tp": tp})
    cfg = load_config(args.config)
    model = build_from_config(cfg, mesh)
    state = model.init_state(seed=0, device=device)
    with open(args.ckpt, "rb") as f:
        load_jax_params(state, pickle.load(f))
    state = model.place_state(state)
    device = state.params["null_context"].device
    cfw = load_cfw(cfg, args.vqgan_ckpt, device) if args.vqgan_ckpt else None
    gen = torch.Generator(device=device).manual_seed(42)
    rank0 = is_main()
    if rank0:
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
                      args.tile_latent, args.colorfix_type, tile_parallel=args.tile_parallel,
                      cfw=cfw)
        if not rank0:
            continue
        out_path = os.path.join(args.outdir, name)
        imwrite(tensor2img(img), out_path)
        print(f"{path} -> {out_path}")


if __name__ == "__main__":
    main()
