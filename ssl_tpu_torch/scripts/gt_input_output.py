"""Dump (GT, input, stage-1 latent, stage-1 sample) quadruplets for CFW training.

    python -m ssl_tpu_torch.scripts.gt_input_output --config cfg.yml --ckpt ckpt_N.pkl \\
        --gt_dir datasets/GT --outdir dump [--ddpm_steps 200] [--n_images 0] \\
        [--seed S] [--device cpu]

Counterpart of ``scripts/gt_input_output.py`` (reference
Diffusion-Based-SR/scripts/gt_input_output.py), with its flags.  For each GT
image (cropped to a square of a multiple of 64): a kernel set and the
two-stage Real-ESRGAN degradation on the host at scale 1 (no pool), so the
input stays at the GT's size; the VAE encode of the input, the spaced-DDPM
sample over the struct-cond encoder and the UNet with the EMA weights
(``--ckpt``, the params pickle either package's training CLI writes, loaded
into the weights and the EMA), and its decode.  Written as the reference
SingleImageNPDataset layout that ``diffusion/cfw_train.py`` reads:
``outdir/{gts,inputs,latents,samples}``, the latent (h/8, w/8, c) as the JAX
script saves it.

The degradation draws from a ``random.Random`` and a
``np.random.RandomState`` that this script owns, seeded by ``--seed``; by
default they are unseeded, as the JAX script's degrader is.  The sampler
draws from a generator seeded 0 (the JAX script's ``PRNGKey(0)``).  The
stage-1 config may be native or reference-schema.  Runs on ``cuda`` unless
``--device`` names another device."""

from __future__ import annotations

import argparse
import os
import pickle
import random

import numpy as np
import torch

from ssl_tpu_torch.data.realesr_degradation import RealESRGANDegrader
from ssl_tpu_torch.data.realesrgan_dataset import _KernelSynth
from ssl_tpu_torch.diffusion.main import build_from_config, load_config
from ssl_tpu_torch.diffusion.sampler import spaced_ddpm_sample
from ssl_tpu_torch.diffusion.test_cli import load_jax_params
from ssl_tpu_torch.utils.img_util import array2img, img2array, imread, imwrite


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--gt_dir", required=True)
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--ddpm_steps", type=int, default=200)
    parser.add_argument("--n_images", type=int, default=0, help="0 = all")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of the degradation's streams (default: unseeded)")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None) -> list[str]:
    """Write the four folders; returns the names dumped."""
    args = parse_args(argv)
    cfg = load_config(args.config)
    model = build_from_config(cfg)
    state = model.init_state(seed=0, device=args.device)
    with open(args.ckpt, "rb") as f:
        load_jax_params(state, pickle.load(f))
    device = state.params["null_context"].device
    vae, params = state.frozen["vae"], model.infer_params(state)
    for sub in ("gts", "inputs", "latents", "samples"):
        os.makedirs(os.path.join(args.outdir, sub), exist_ok=True)

    rng, np_rng = random.Random(args.seed), np.random.RandomState(args.seed)
    synth = _KernelSynth({}, rng, np_rng)
    degrader = RealESRGANDegrader(cfg.get("degradation", {}), scale=1, queue_size=0)
    degrader.rng, degrader.pyrng = np_rng, rng
    gen = torch.Generator(device=device).manual_seed(0)
    ctx = params["null_context"][None]

    def apply_fn(x, t, c, z_lq):
        return model.apply_model(params, x, t, c, z_lq)

    names = sorted(os.listdir(args.gt_dir))
    if args.n_images:
        names = names[:args.n_images]
    for name in names:
        gt = img2array(imread(os.path.join(args.gt_dir, name)))
        size = min(gt.shape[0], gt.shape[1]) // 64 * 64
        if size == 0:
            raise ValueError(f"{name}: {gt.shape[0]} x {gt.shape[1]} is smaller than 64 x 64")
        gt = gt[:size, :size]
        k1, k2, sinc = synth.sample()
        # at scale 1 the input is already at the GT's size (the JAX script's
        # cv2.resize to that size returns it unchanged)
        lq = degrader.degrade_batch(gt[None], k1[None], k2[None], sinc[None])[0]
        lq_t = torch.from_numpy(np.ascontiguousarray(lq.transpose(2, 0, 1)))[None].to(device)
        with torch.no_grad():
            z_lq = model.encode(vae, lq_t * 2 - 1, gen)
            z = spaced_ddpm_sample(apply_fn, model.sched, z_lq.shape, gen, ctx, z_lq,
                                   steps=args.ddpm_steps)
            out = torch.clamp((model.decode(vae, z) + 1) / 2, 0, 1)[0]
        imwrite(array2img(gt), os.path.join(args.outdir, "gts", name))
        imwrite(array2img(lq), os.path.join(args.outdir, "inputs", name))
        stem = os.path.splitext(name)[0]
        np.save(os.path.join(args.outdir, "latents", stem + ".npy"),
                z[0].permute(1, 2, 0).cpu().numpy())
        imwrite(array2img(out.permute(1, 2, 0).cpu().numpy()),
                os.path.join(args.outdir, "samples", name))
        print(name, flush=True)
    return names


if __name__ == "__main__":
    main()
